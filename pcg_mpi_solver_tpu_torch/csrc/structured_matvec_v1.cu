// Structured-slab block-stencil matvec for Hopper (sm_90a), float: the
// x-march.
//
// Replaces pcg_mpi_solver_tpu/ops/pallas_matvec.py::structured_matvec_pallas
// (v1, kernel _matvec_kernel), which the JAX package's structured backend
// launches for every f32 matvec under PCG_TPU_PALLAS_V=1, and its per-part
// dispatch batched_structured_matvec: one launch covers the part axis.
//
// Function (StructuredOps.matvec_local, one slab per part p):
//   y[p] = sum_b shift_b( sum_a Ke[3b:3b+3, 3a:3a+3] . (ck[p] * x[p]_a) )
// x, y: (P, 3, nx+1, ny+1, nz+1); ck: (P, nx, ny, nz); Ke: (24, 24) in
// element-dof order 3*corner + comp, corners in VTK order.
//
// What bounds it on an H100 SXM: 576 FMAs per cell against ~28 bytes per
// cell, so the operations (58.0 us at 150^3 at 67 TFLOP/s fp32, against
// 28.7 us for the bytes at 3.35 TB/s), as for every variant.  What bounds
// this design is instruction issue: Ke's constants reach the FFMAs through
// uniform registers, one ULDC.64 for two Ke entries.
//
// The TPU kernel marches one grid step per node plane and carries the
// cells' dx=1 partial sums to the next step in VMEM scratch.  Here the
// march is a loop inside each thread, the carry registers:
//   * a thread owns kNodes z-adjacent node columns (p, iy, iz0 .. iz0 +
//     kNodes - 1) and marches x; for each cell plane i it takes the rows of
//     Ke that land on its nodes from the cells of that plane around them:
//     the dx=0 corners finish node plane i, the dx=1 corners are carried to
//     node plane i+1 (no atomics, so the result is the same bit for bit run
//     to run).  The nodes share each Ke constant and their window of x;
//   * x slides through registers: the 3 x (kNodes + 2) (y, z) window of
//     node planes i and i+1; plane i+1's becomes plane i's and plane i+2's
//     is loaded after the step, from L1, where the step asked for it first
//     (the warps of a scheduler march in step, so a load's latency is not
//     hidden by the others');
//   * a missing cell (off the slab in y or z) gets ck = 0, the window's
//     rows are clamped onto the slab and its columns off the slab are not
//     loaded (they keep an older finite value), so every column runs one
//     path: loads at immediate offsets from one pointer a row, masked by
//     the column's own bits, no bounds test in the march (a value off the
//     slab only meets cells whose ck is 0);
//   * the grid is the card's resident blocks, no more: each block marches a
//     contiguous run of the (column tile, node plane) work, every run the
//     same number of planes within one, and starts a column tile's march
//     again where its run crosses into the next tile (at plane 0: no carry
//     to recompute).  A run that starts at plane s > 0 first recomputes the
//     carry of cell plane s - 1 (its dx=1 corners only, half a plane);
//   * each node keeps the FMA order of the v1 before it (commit 1aab56a:
//     a thread a node column and 16-plane segment): a, then c; the
//     corners' sums in b order; carry + lo; so it gives that kernel's bits;
//   * Ke lives in the constant bank with every loop unrolled, so each Ke
//     entry is a compile-time constant-bank operand;
//   * threads run fastest along z, so a warp's loads are contiguous.

#include <cuda_runtime.h>

#include "structured_common.cuh"

namespace {

using smv::corner_x;
using smv::corner_y;
using smv::corner_z;

constexpr int kThreads = 128;
constexpr int kNodes = 2;          // z-adjacent node columns a thread
constexpr int kMinBlocks = 3;      // blocks an SM the launch bounds promise
constexpr int kWz = kNodes + 2;    // window width in z
constexpr int kCz = kNodes + 1;    // cells in z around a thread's nodes

__constant__ float ke_v1[24 * 24];

// p, through a register the compiler cannot see into: it keeps a pointer
// it computed once instead of folding every load's offset back into the
// kernel parameter it came from (a 64-bit address computation a load).
template <typename T>
__device__ __forceinline__ T* opaque(T* p) {
  asm("" : "+l"(p));
  return p;
}

// One thread's node columns: where its window, cells and outputs lie.
// Rows off the slab in y are clamped onto it; columns off it in z are not
// loaded (the window keeps an older, finite value there).
struct Column {
  const float* x;         // part p's x at node (c 0, plane 0, row 0, iz0)
  const float* ck;        // part p's ck at cell (plane 0, row 0, iz0)
  float* y;               // part p's y at node (c 0, plane 0, iy, iz0)
  int row[3];             // window row dy: clamped node row x (nz + 1)
  int crow[2];            // cell row ey: clamped cell row x nz
  unsigned zin;           // bit kz: window column kz is in the slab
  unsigned live;          // bit ey * kCz + k: that cell is in the slab
  int n_out;              // nodes of the thread inside the slab
};

// w[c][dy][kz] = x[c] at node (px, iy + dy - 1, iz0 + kz - 1), rows
// clamped, columns off the slab left as they were.
__device__ __forceinline__ void load_plane(float (&w)[3][3][kWz],
                                           const Column& col, int px,
                                           int plane, int grid) {
  const float* xp = opaque(col.x + px * plane);
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const float* q = xp + (c * grid + col.row[dy]);
#pragma unroll
      for (int kz = 0; kz < kWz; ++kz)
        if ((col.zin >> kz) & 1u) w[c][dy][kz] = __ldg(q + kz - 1);
    }
}

// Asks L1 for the rows of node plane px that load_plane will read, so
// that the loads issued after a step find them there.
__device__ __forceinline__ void prefetch_plane(const Column& col, int px,
                                               int plane, int grid) {
  const float* xp = opaque(col.x + px * plane);
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const float* q = xp + (c * grid + col.row[dy]);
      asm volatile("prefetch.global.L1 [%0];" ::"l"(q));
    }
}

// sc[ey][k] = ck of cell (i, iy - ey, iz0 + k - 1), 0 if it is missing.
__device__ __forceinline__ void load_cells(float (&sc)[2][kCz],
                                           const Column& col, int i,
                                           int cplane) {
  const float* cp = opaque(col.ck + i * cplane);
#pragma unroll
  for (int ey = 0; ey < 2; ++ey)
#pragma unroll
    for (int k = 0; k < kCz; ++k) {
      sc[ey][k] = 0.f;
      if ((col.live >> (ey * kCz + k)) & 1u)
        sc[ey][k] = __ldg(cp + col.crow[ey] + k - 1);
    }
}

// acc[n][r] = sum over the corners b of dx = Dx, in b order, of
// sc(cell of node n as corner b) * (Ke[3b + r, :] . x of that cell), the
// cell's corners at dx 0 in `lo` and dx 1 in `hi`.
template <int Dx>
__device__ __forceinline__ void corners(const float (&lo)[3][3][kWz],
                                        const float (&hi)[3][3][kWz],
                                        const float (&sc)[2][kCz],
                                        float (&acc)[kNodes][3]) {
#pragma unroll
  for (int n = 0; n < kNodes; ++n)
#pragma unroll
    for (int r = 0; r < 3; ++r) acc[n][r] = 0.f;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    if (corner_x(b) != Dx) continue;
    const int ey = corner_y(b), ez = corner_z(b);
    float t[kNodes][3];
#pragma unroll
    for (int n = 0; n < kNodes; ++n)
#pragma unroll
      for (int r = 0; r < 3; ++r) t[n][r] = 0.f;
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int oy = corner_y(a) - ey + 1;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int col = 3 * a + c;
#pragma unroll
        for (int n = 0; n < kNodes; ++n) {
          const int kz = n - ez + corner_z(a) + 1;
          const float v = corner_x(a) ? hi[c][oy][kz] : lo[c][oy][kz];
#pragma unroll
          for (int r = 0; r < 3; ++r)
            t[n][r] += ke_v1[(3 * b + r) * 24 + col] * v;
        }
      }
    }
#pragma unroll
    for (int n = 0; n < kNodes; ++n)
#pragma unroll
      for (int r = 0; r < 3; ++r) acc[n][r] += sc[ey][n - ez + 1] * t[n][r];
  }
}

// Node plane i of the column from node planes i (lo) and i + 1 (hi):
// y[i] = carry + the dx = 0 corners of cell plane i; then, if node plane
// i + 1 is this run's, carry = its dx = 1 corners.
__device__ __forceinline__ void step(const float (&lo)[3][3][kWz],
                                     const float (&hi)[3][3][kWz],
                                     const Column& col, int i, bool carry_on,
                                     float (&carry)[kNodes][3], int plane,
                                     int cplane, int grid) {
  float sc[2][kCz];
  load_cells(sc, col, i, cplane);
  float acc[kNodes][3];
  corners<0>(lo, hi, sc, acc);
  float* yp = opaque(col.y + i * plane);
#pragma unroll
  for (int n = 0; n < kNodes; ++n)
    if (n < col.n_out)
#pragma unroll
      for (int r = 0; r < 3; ++r) yp[r * grid + n] = carry[n][r] + acc[n][r];
  if (carry_on) corners<1>(lo, hi, sc, carry);
}

// Node planes s .. e - 1 of the column.
__device__ __forceinline__ void march(const Column& col, int s, int e,
                                      int nx, int plane, int cplane,
                                      int grid) {
  const int end = min(e, nx);      // node planes with a cell plane
  float a[3][3][kWz], b[3][3][kWz];
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int kz = 0; kz < kWz; ++kz) a[c][dy][kz] = b[c][dy][kz] = 0.f;
  float carry[kNodes][3];
  if (s > 0) {
    // the carry of cell plane s - 1
    float sc[2][kCz];
    load_cells(sc, col, s - 1, cplane);
    load_plane(a, col, s - 1, plane, grid);
    load_plane(b, col, s, plane, grid);
    corners<1>(a, b, sc, carry);
  } else {
#pragma unroll
    for (int n = 0; n < kNodes; ++n)
#pragma unroll
      for (int r = 0; r < 3; ++r) carry[n][r] = 0.f;
    load_plane(b, col, s, plane, grid);
  }
  // b holds node plane s, a node plane s + 1
  if (s < end) load_plane(a, col, s + 1, plane, grid);
  for (int i = s; i < end; ++i) {
    if (i + 2 <= end) prefetch_plane(col, i + 2, plane, grid);
    step(b, a, col, i, i + 1 < e, carry, plane, cplane, grid);
    if (i + 1 < end) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int kz = 0; kz < kWz; ++kz) b[c][dy][kz] = a[c][dy][kz];
      load_plane(a, col, i + 2, plane, grid);
    }
  }
  if (e > nx) {
    // node plane nx has no cell plane: carry + 0
    float* yp = opaque(col.y + nx * plane);
#pragma unroll
    for (int n = 0; n < kNodes; ++n)
      if (n < col.n_out)
#pragma unroll
        for (int r = 0; r < 3; ++r) yp[r * grid + n] = carry[n][r] + 0.f;
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
matvec_v1_kernel(const float* __restrict__ x, const float* __restrict__ ck,
                 float* __restrict__ y, int nx, int ny, int nz,
                 int n_cols, int n_tiles) {
  const int nxn = nx + 1, nyn = ny + 1, nzn = nz + 1;
  const int plane = nyn * nzn, cplane = ny * nz, grid = nxn * plane;
  const int zcols = (nzn + kNodes - 1) / kNodes;
  // this block's run of the (tile, plane) work: every block gets `per`
  // planes and the first `more` one more
  const long long work = static_cast<long long>(n_tiles) * nxn;
  const long long per = work / gridDim.x, more = work % gridDim.x;
  const long long k = blockIdx.x;
  long long u = k * per + min(k, more);
  const long long u1 = u + per + (k < more ? 1 : 0);
  while (u < u1) {
    const int tile = static_cast<int>(u / nxn);
    const int s = static_cast<int>(u % nxn);
    const int e = static_cast<int>(min(static_cast<long long>(nxn),
                                       s + (u1 - u)));
    u += e - s;
    const int id = tile * kThreads + threadIdx.x;
    if (id >= n_cols) continue;
    const int iz0 = (id % zcols) * kNodes;
    const int iy = (id / zcols) % nyn;
    const int p = id / zcols / nyn;
    Column col;
    col.x = opaque(x + static_cast<size_t>(p) * 3 * grid + iz0);
    col.ck = opaque(ck + static_cast<size_t>(p) * nx * cplane + iz0);
    col.y = opaque(y + static_cast<size_t>(p) * 3 * grid + iy * nzn + iz0);
    col.n_out = min(kNodes, nzn - iz0);
    col.zin = 0;
    col.live = 0;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
      col.row[dy] = min(max(iy + dy - 1, 0), ny) * nzn;
#pragma unroll
    for (int kz = 0; kz < kWz; ++kz)
      if (iz0 + kz - 1 >= 0 && iz0 + kz - 1 <= nz) col.zin |= 1u << kz;
#pragma unroll
    for (int ey = 0; ey < 2; ++ey) {
      const int cy = iy - ey;
      col.crow[ey] = min(max(cy, 0), ny - 1) * nz;
#pragma unroll
      for (int kk = 0; kk < kCz; ++kk) {
        const int cz = iz0 + kk - 1;
        if (cy >= 0 && cy < ny && cz >= 0 && cz < nz)
          col.live |= 1u << (ey * kCz + kk);
      }
    }
    march(col, s, e, nx, plane, cplane, grid);
  }
}

int launch(const void* x, const void* ck, void* y, int parts, int nx, int ny,
           int nz, int blocks, cudaStream_t stream) {
  const long long n_cols = static_cast<long long>(parts) * (ny + 1) *
                           ((nz + 1 + kNodes - 1) / kNodes);
  if (n_cols >= (1LL << 31) || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = static_cast<int>((n_cols + kThreads - 1) / kThreads);
  matvec_v1_kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(ck),
      static_cast<float*>(y), nx, ny, nz, static_cast<int>(n_cols), n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points.  stage copies ke (24,24), a contiguous float device
// buffer, into this library's constant bank on `device`.  The matvec takes
// x (P,3,nx+1,ny+1,nz+1) and ck (P,nx,ny,nz), contiguous float device
// buffers, and writes y, allocated by the caller with x's shape, using the
// Ke staged last, with `blocks` blocks (ops/structured_matvec.py::
// v1_geometry: the card's resident blocks; any count from 1 gives the same
// y).  The wrapper (ops/structured_matvec.py) checks shapes, dtype and
// contiguity and keeps every index below 2^31.  Each returns the CUDA error
// code of its copy or launch (0 = done / launched).  blocks_per_sm returns
// the blocks of the kernel an SM of `device` holds (what v1_geometry
// assumes) and registers the kernel's registers a thread, or minus a CUDA
// error code.
extern "C" int structured_matvec_v1_stage_f32(const void* ke, int device,
                                              void* stream) {
  return smv::stage(ke_v1, ke, device, stream);
}

extern "C" int structured_matvec_v1_f32(const void* x, const void* ck,
                                        void* y, int parts, int nx, int ny,
                                        int nz, int blocks, int device,
                                        void* stream) {
  smv::DeviceScope scope(device);
  if (scope.error() != 0) return scope.error();
  return launch(x, ck, y, parts, nx, ny, nz, blocks,
                static_cast<cudaStream_t>(stream));
}

extern "C" int structured_matvec_v1_blocks_per_sm(int device) {
  smv::DeviceScope scope(device);
  if (scope.error() != 0) return -scope.error();
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, matvec_v1_kernel, kThreads, 0);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

extern "C" int structured_matvec_v1_registers(int device) {
  smv::DeviceScope scope(device);
  if (scope.error() != 0) return -scope.error();
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, matvec_v1_kernel);
  return e == cudaSuccess ? attr.numRegs : -static_cast<int>(e);
}

SMV_ERROR_STRING(structured_matvec_v1)
