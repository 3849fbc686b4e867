// Structured-slab block-stencil matvec for Hopper (sm_90a), float: flat
// lanes, chunks of planes in a cp.async ring, one 24-row product per cell
// placed into shared-memory node accumulators.
//
// Replaces pcg_mpi_solver_tpu/ops/pallas_matvec.py::structured_matvec_pallas_v4
// (kernel _matvec_kernel_v4), which the JAX package's structured backend
// launches for every f32 matvec under PCG_TPU_PALLAS_V=4, and its per-part
// dispatch batched_structured_matvec: one launch covers the part axis.
//
// Function (StructuredOps.matvec_local, one slab per part p):
//   y[p] = sum_b shift_b( sum_a Ke[3b:3b+3, 3a:3a+3] . (ck[p] * x[p]_a) )
// x, y: (P, 3, nx+1, ny+1, nz+1); ck: (P, nx, ny, nz); Ke: (24, 24) in
// element-dof order 3*corner + comp, corners in VTK order.
//
// What bounds it on an H100 SXM: 576 FMAs per cell against ~28 bytes per
// cell, so the operations (58.0 us at 150^3 at 67 TFLOP/s fp32, against
// 28.7 us for the bytes at 3.35 TB/s).
//
// The TPU kernel is cell-centred: a node plane is m = (ny+1)(nz+1) flat
// lanes, the cells sit at node strides (lane q = y (nz+1) + z, corner a at
// lane q + off_a, off_a = dy (nz+1) + dz), and per cell plane it builds
// u = ck * x at the eight corners, does one (24,24)@(24,m) product and
// adds the product's eight 3-row blocks at lane offset off_b, dx = 0 into
// this node plane and dx = 1 into a carry for the next.  Chunks of C =
// PCG_TPU_PALLAS_PLANES cell planes keep the plane axis as an array axis
// and are double-buffered.  Here the idea stays cell-centred:
//   * a block owns L output lanes [l0, l0 + L) of one x segment of
//     kChunks * C - 1 node planes; their nodes take cells from the lanes
//     [l0 - H, l0 + L), H = nz + 2, so the block computes those cells and
//     stages the node lanes [l0 - H, l0 + L + H).  The H halo cells are
//     computed by the block before too, which writes the nodes they feed
//     there (owner writes, no atomics): (L + H) / L of the product's FMAs,
//     1.30x at 150^3 and C = 8;
//   * a chunk stages its C + 1 node planes as [comp][plane][lane] (no
//     flattened C * m axis) in a two-slot ring filled by cp.async, 4 bytes
//     a value, zero-filled off the grid: chunk k + 1's copies are in
//     flight while chunk k computes;
//   * per cell plane each thread computes the whole 24-vector v = ck (Ke .
//     u) of its cell (ck read once from device memory; below, why ck
//     scales the product), then places its eight 3-blocks into two
//     shared-memory node accumulators, slot i & 1 for node plane i (dx = 0
//     rows land in this plane's slot, dx = 1 rows in the next one's, which
//     is the carry), in eight passes separated by __syncthreads.  A pass maps cells one to
//     one onto nodes, so no two threads add to one value and the sum order
//     is fixed: the same result bit for bit run to run;
//   * a node plane is written to device memory once its last cell plane is
//     placed, and its slot is zeroed for the node plane two ahead;
//   * a segment first recomputes the carry of the cell plane before it;
//     node planes past nx are zero-filled, cell planes past nx - 1 skipped;
//   * Ke lives in the constant bank with every loop unrolled.
// The TPU kernel scales the 24 gathered inputs by ck; here ck scales the 24
// results, as the TPU's v6-v9 do: one rounding a result instead of one an
// input ahead of a sum that cancels (each component's columns of a Ke row
// sum to zero).  Scaling the inputs here agreed as well with the plain
// version, but moved the stagnation exit of the flagship's second f32
// cycle ~200 iterations early, out of the 5 % window (PERF.md, Findings).
// L is chosen at launch: the widest multiple of 32, at most kMaxLanes,
// whose two stages of 3 (C+1) (L + 2H) floats and 6 L accumulators fit in
// 227 KB - at 150^3, L = 512 (184.1 KB) at C = 8 and L = 224 (215.6 KB,
// halo cost 1.68x) at C = 16.  A launch where even 32 lanes do not fit is
// refused (cudaErrorInvalidConfiguration).

#include <cuda_runtime.h>

#include "structured_common.cuh"

namespace {

using smv::copy4;
using smv::corner_x;
using smv::corner_y;
using smv::corner_z;

constexpr int kThreads = 256;
constexpr int kMaxLanes = 512;      // output lanes of a block, at most
constexpr int kChunks = 2;          // chunks per x segment

__constant__ float ke_v4[24 * 24];

size_t smem_bytes(int C, int L, int sy) {
  const size_t W = static_cast<size_t>(L) + 2 * (sy + 1);
  return sizeof(float) * (2 * 3 * (C + 1) * W + 2 * 3 * static_cast<size_t>(L));
}

__global__ void __launch_bounds__(kThreads)
matvec_v4_kernel(const float* __restrict__ x, const float* __restrict__ ck,
                 float* __restrict__ y, int nx, int ny, int nz, int C, int L,
                 int n_tiles, int n_seg) {
  extern __shared__ float smem[];
  const int nxn = nx + 1, sy = nz + 1, m = (ny + 1) * sy, grid = nxn * m;
  const int H = sy + 1;            // cell lanes before the tile
  const int W = L + 2 * H;         // staged node lanes [l0 - H, l0 + L + H)
  const int n_cells = L + H;       // cell lanes [l0 - H, l0 + L)
  int blk = blockIdx.x;
  const int tile = blk % n_tiles;
  blk /= n_tiles;
  const int seg = blk % n_seg;
  const int p = blk / n_seg;
  const int l0 = tile * L;
  const int w0 = l0 - H;           // lane of staged node 0 and of cell 0
  const float* xp = x + static_cast<size_t>(p) * 3 * grid;
  const float* ckp = ck + static_cast<size_t>(p) * nx * ny * nz;
  float* yp = y + static_cast<size_t>(p) * 3 * grid;
  const int tid = threadIdx.x;

  const int seg_len = kChunks * C - 1;
  const int x0 = seg * seg_len;
  const int x_end = min(x0 + seg_len, nxn);
  // cell planes x0-1 .. x_end-1, C a chunk
  const int n_chunks = (x_end - x0 + C) / C;
  const int slot_floats = 3 * (C + 1) * W;
  float* acc = smem + 2 * slot_floats;   // [node plane & 1][comp][L]

  // stage [c][r][w] holds node (pbase + r, lane w0 + w)
  auto issue = [&](int k) {
    float* xs = smem + (k & 1) * slot_floats;
    const int pbase = x0 - 1 + k * C;
    for (int e = tid; e < slot_floats; e += kThreads) {
      const int w = e % W;
      const int t = e / W;
      const int r = t % (C + 1), c = t / (C + 1);
      const int gp = pbase + r, gl = w0 + w;
      const bool ok = gp >= 0 && gp < nxn && gl >= 0 && gl < m;
      copy4(xs + e, ok ? xp + c * grid + gp * m + gl : xp, ok);
    }
    smv::commit_copies();
  };

  for (int e = tid; e < 6 * L; e += kThreads) acc[e] = 0.f;
  issue(0);
  for (int k = 0; k < n_chunks; ++k) {
    if (k + 1 < n_chunks) {
      issue(k + 1);
      smv::wait_copies<1>();
    } else {
      smv::wait_copies<0>();
    }
    __syncthreads();
    const float* xs = smem + (k & 1) * slot_floats;
    const int pbase = x0 - 1 + k * C;
    for (int r = 0; r < C && pbase + r < x_end; ++r) {
      const int i = pbase + r;
      if (i >= 0 && i < nx) {         // the same for the whole block
        for (int q0 = 0; q0 < n_cells; q0 += kThreads) {
          const int qq = q0 + tid;    // this thread's cell, lane w0 + qq
          const int q = w0 + qq;
          const int cy = q / sy, cz = q - cy * sy;
          const bool ok = qq < n_cells && q >= 0 && q < m && cy < ny &&
                          cz < nz;
          float v[24];
          if (ok) {
            const float s = __ldg(ckp + (i * ny + cy) * nz + cz);
            float u[24];
#pragma unroll
            for (int a = 0; a < 8; ++a) {
              const float* xa = xs + (r + corner_x(a)) * W + qq +
                                corner_y(a) * sy + corner_z(a);
#pragma unroll
              for (int c = 0; c < 3; ++c) u[3 * a + c] = xa[c * (C + 1) * W];
            }
#pragma unroll
            for (int d = 0; d < 24; ++d) {
              float t = 0.f;
#pragma unroll
              for (int e = 0; e < 24; ++e) t += ke_v4[d * 24 + e] * u[e];
              v[d] = s * t;
            }
          }
          // corner b of this cell is the node at lane q + off_b
#pragma unroll
          for (int b = 0; b < 8; ++b) {
            __syncthreads();
            const int n = qq - H + corner_y(b) * sy + corner_z(b);
            if (ok && n >= 0 && n < L) {
              float* an = acc + ((i + corner_x(b)) & 1) * 3 * L + n;
              an[0] += v[3 * b];
              an[L] += v[3 * b + 1];
              an[2 * L] += v[3 * b + 2];
            }
          }
        }
      }
      __syncthreads();
      // node plane i has all its cells: write it, free its slot
      float* ai = acc + (i & 1) * 3 * L;
      for (int e = tid; e < 3 * L; e += kThreads) {
        const int c = e / L, l = l0 + e - c * L;
        if (i >= x0 && l < m) yp[c * grid + i * m + l] = ai[e];
        ai[e] = 0.f;
      }
      // the next plane's first placement pass starts with a barrier
    }
    __syncthreads();          // this slot is refilled by chunk k + 2
  }
}

int launch(const void* x, const void* ck, void* y, int parts, int nx, int ny,
           int nz, int planes, cudaStream_t stream) {
  const int C = max(1, min(planes, nx + 1));
  const int sy = nz + 1, m = (ny + 1) * sy;
  int L = min(kMaxLanes, (m + 31) / 32 * 32);
  while (L > 32 && smem_bytes(C, L, sy) > smv::kMaxSmemBytes) L -= 32;
  const int n_tiles = (m + L - 1) / L;
  const int seg_len = kChunks * C - 1;
  const int n_seg = (nx + 1 + seg_len - 1) / seg_len;
  const long long blocks = static_cast<long long>(parts) * n_seg * n_tiles;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(C, L, sy);
  cudaError_t e = smv::allow_smem(matvec_v4_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  matvec_v4_kernel<<<static_cast<int>(blocks), kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(ck),
      static_cast<float*>(y), nx, ny, nz, C, L, n_tiles, n_seg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points.  stage copies ke (24,24), a contiguous float device
// buffer, into this library's constant bank on `device`.  The matvec takes
// x (P,3,nx+1,ny+1,nz+1) and ck (P,nx,ny,nz), contiguous float device
// buffers, and writes y, allocated by the caller with x's shape, using the
// Ke staged last; `planes` is C (PCG_TPU_PALLAS_PLANES, clamped to
// [1, nx+1]).  The wrapper (ops/structured_matvec.py) checks shapes, dtype
// and contiguity and keeps every index below 2^31.  Each returns the CUDA
// error code of its copy or launch (0 = done / launched).
extern "C" int structured_matvec_v4_stage_f32(const void* ke, int device,
                                              void* stream) {
  return smv::stage(ke_v4, ke, device, stream);
}

extern "C" int structured_matvec_v4_f32(const void* x, const void* ck,
                                        void* y, int parts, int nx, int ny,
                                        int nz, int planes, int device,
                                        void* stream) {
  smv::DeviceScope scope(device);
  if (scope.error() != 0) return scope.error();
  return launch(x, ck, y, parts, nx, ny, nz, planes,
                static_cast<cudaStream_t>(stream));
}

SMV_ERROR_STRING(structured_matvec_v4)
