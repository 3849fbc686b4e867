// Structured-slab block-stencil matvec for Hopper (sm_90a), float: (y, z)
// cell tiles marching x one plane a step, one single-buffered stage a
// chunk, the chunk's output planes kept in shared memory and written once.
//
// Replaces pcg_mpi_solver_tpu/ops/pallas_matvec.py::structured_matvec_pallas_v8
// (kernel _matvec_kernel_v8), which the JAX package's structured backend
// launches for every f32 matvec under PCG_TPU_PALLAS_V=8, and its per-part
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
// The TPU kernel is v6's compute (per cell plane, per output corner b a
// (3,24)@(24,m) product of the unscaled gathered corners, scaled by ck
// afterwards, rotated to its lane offset and added, dx = 1 rows carried to
// the next plane) with the plane loop made a grid axis, grid (g, C): the
// output block of C = PCG_TPU_PALLAS_PLANES planes stays resident across
// the C inner steps and is written once; the slab of the chunk's planes
// is copied once per chunk into a single buffer, with no prefetch.  Here:
//   * a block of kCy x kCz threads owns one cell each of a kCy x kCz cell
//     tile, (iy0 - 1 .. iy0 + kCy - 2, iz0 - 1 .. iz0 + kCz - 2), and the
//     (kCy-1) x (kCz-1) node tile those cells surround (every cell of an
//     owned node is in the tile; the tile's outer ring of nodes belongs to
//     the neighbouring blocks, which compute those cells again: kCy kCz /
//     ((kCy-1)(kCz-1)) = 1.18x the product's FMAs, no atomics);
//   * the block marches one x segment of kChunks * C - 1 node planes in
//     chunks of C cell planes, one plane a step (the TPU's inner grid
//     axis).  A chunk loads its C + 1 node planes of the tile and its halo
//     into one shared buffer with plain loads, synchronises and computes:
//     no overlap of copy and compute, as the TPU kernel chose;
//   * per cell plane each thread gathers its cell's 24 corner values and,
//     per output corner b, does the 3 x 24 product with Ke[3b:3b+3],
//     scales the 3 results by ck (ck scales the product, not the 24
//     inputs) and adds them to the node (r + dx_b, y + dy_b, z + dz_b) of a
//     shared output block of C + 1 node planes.  The eight additions are
//     separated by __syncthreads; each maps cells one to one onto nodes, so
//     no two threads add to one value and the sum order is fixed (the same
//     result bit for bit run to run);
//   * after the chunk's C planes the block writes output planes 0 .. C-1
//     to device memory at once, z fastest (coalesced stores), moves plane C
//     (the dx = 1 carry) to plane 0 and zeroes the rest;
//   * a segment first recomputes the carry of the cell plane before it;
//     node planes past nx are zero-filled, cell planes past nx - 1 skipped;
//   * Ke lives in the constant bank with every loop unrolled.
// Shared memory: 4 * 3 (C+1) ((kCy+1)(kCz+1) + (kCy-1)(kCz-1)) bytes, 54.2
// KB at C = 8 and 102.4 KB at C = 16; the launch is refused above 227 KB
// (C above 36).

#include <cuda_runtime.h>

#include "structured_common.cuh"

namespace {

using smv::corner_x;
using smv::corner_y;
using smv::corner_z;

constexpr int kCy = 8, kCz = 32;              // cell tile: a thread a cell
constexpr int kThreads = kCy * kCz;
constexpr int kTy = kCy - 1, kTz = kCz - 1;   // owned node tile
constexpr int kNy = kCy + 1, kNz = kCz + 1;   // staged node tile
constexpr int kChunks = 2;                    // chunks per segment

__constant__ float ke_v8[24 * 24];

size_t smem_bytes(int C) {
  return sizeof(float) * 3 * (C + 1) *
         static_cast<size_t>(kNy * kNz + kTy * kTz);
}

__global__ void __launch_bounds__(kThreads)
matvec_v8_kernel(const float* __restrict__ x, const float* __restrict__ ck,
                 float* __restrict__ y, int nx, int ny, int nz, int C,
                 int n_ty, int n_tz, int n_seg) {
  extern __shared__ float smem[];
  const int nxn = nx + 1, nyn = ny + 1, nzn = nz + 1;
  const int grid = nxn * nyn * nzn;
  int blk = blockIdx.x;
  const int iz0 = (blk % n_tz) * kTz;
  blk /= n_tz;
  const int iy0 = (blk % n_ty) * kTy;
  blk /= n_ty;
  const int seg = blk % n_seg;
  const int p = blk / n_seg;
  const float* xp = x + static_cast<size_t>(p) * 3 * grid;
  const float* ckp = ck + static_cast<size_t>(p) * nx * ny * nz;
  float* yp = y + static_cast<size_t>(p) * 3 * grid;
  const int tid = threadIdx.x;
  const int ty = tid / kCz, tz = tid % kCz;
  const int cy = iy0 - 1 + ty, cz = iz0 - 1 + tz;   // this thread's cell
  const bool cell_ok = cy >= 0 && cy < ny && cz >= 0 && cz < nz;

  const int seg_len = kChunks * C - 1;
  const int x0 = seg * seg_len;
  const int x_end = min(x0 + seg_len, nxn);
  // cell planes x0-1 .. x_end-1, C a chunk
  const int n_chunks = (x_end - x0 + C) / C;
  // xs [c][r][yy][zz]: node (pbase + r, iy0 - 1 + yy, iz0 - 1 + zz);
  // out [c][r][oy][oz]: node (pbase + r, iy0 + oy, iz0 + oz)
  float* xs = smem;
  float* out = smem + 3 * (C + 1) * kNy * kNz;
  const int out_plane = kTy * kTz;

  for (int e = tid; e < 3 * (C + 1) * out_plane; e += kThreads) out[e] = 0.f;
  for (int k = 0; k < n_chunks; ++k) {
    const int pbase = x0 - 1 + k * C;
    for (int e = tid; e < 3 * (C + 1) * kNy * kNz; e += kThreads) {
      const int zz = e % kNz;
      int t = e / kNz;
      const int yy = t % kNy;
      t /= kNy;
      const int r = t % (C + 1), c = t / (C + 1);
      const int gp = pbase + r, gy = iy0 - 1 + yy, gz = iz0 - 1 + zz;
      const bool ok = gp >= 0 && gp < nxn && gy >= 0 && gy < nyn &&
                      gz >= 0 && gz < nzn;
      xs[e] = ok ? xp[c * grid + (gp * nyn + gy) * nzn + gz] : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < C && pbase + r < x_end; ++r) {
      const int i = pbase + r;
      if (i < 0 || i >= nx) continue;       // the same for the whole block
      float u[24];
      float s = 0.f;
      if (cell_ok) {
        s = __ldg(ckp + (i * ny + cy) * nz + cz);
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          const float* xa =
              xs + ((r + corner_x(a)) * kNy + ty + corner_y(a)) * kNz + tz +
              corner_z(a);
#pragma unroll
          for (int c = 0; c < 3; ++c)
            u[3 * a + c] = xa[c * (C + 1) * kNy * kNz];
        }
      }
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        float t0 = 0.f, t1 = 0.f, t2 = 0.f;
        if (cell_ok) {
#pragma unroll
          for (int e = 0; e < 24; ++e) {
            t0 += ke_v8[(3 * b + 0) * 24 + e] * u[e];
            t1 += ke_v8[(3 * b + 1) * 24 + e] * u[e];
            t2 += ke_v8[(3 * b + 2) * 24 + e] * u[e];
          }
        }
        __syncthreads();
        // corner b of this cell is the node (i + dx, cy + dy, cz + dz)
        const int oy = ty - 1 + corner_y(b), oz = tz - 1 + corner_z(b);
        if (cell_ok && oy >= 0 && oy < kTy && oz >= 0 && oz < kTz) {
          float* o = out + (r + corner_x(b)) * out_plane + oy * kTz + oz;
          o[0] += s * t0;
          o[(C + 1) * out_plane] += s * t1;
          o[2 * (C + 1) * out_plane] += s * t2;
        }
      }
    }
    __syncthreads();
    // output planes 0 .. C-1 are node planes pbase .. pbase + C - 1, done
    for (int e = tid; e < 3 * C * out_plane; e += kThreads) {
      const int oz = e % kTz;
      int t = e / kTz;
      const int oy = t % kTy;
      t /= kTy;
      const int r = t % C, c = t / C;
      const int gp = pbase + r, gy = iy0 + oy, gz = iz0 + oz;
      if (gp >= x0 && gp < x_end && gy < nyn && gz < nzn)
        yp[c * grid + (gp * nyn + gy) * nzn + gz] =
            out[(c * (C + 1) + r) * out_plane + oy * kTz + oz];
    }
    __syncthreads();
    // plane C (the carry) becomes plane 0; one thread per (c, node) column
    for (int e = tid; e < 3 * out_plane; e += kThreads) {
      const int c = e / out_plane, n = e - c * out_plane;
      float* col = out + c * (C + 1) * out_plane + n;
      col[0] = col[C * out_plane];
      for (int r = 1; r <= C; ++r) col[r * out_plane] = 0.f;
    }
    __syncthreads();          // before the next chunk's loads and adds
  }
}

int launch(const void* x, const void* ck, void* y, int parts, int nx, int ny,
           int nz, int planes, cudaStream_t stream) {
  const int C = max(1, min(planes, nx + 1));
  const int n_ty = (ny + 1 + kTy - 1) / kTy, n_tz = (nz + 1 + kTz - 1) / kTz;
  const int seg_len = kChunks * C - 1;
  const int n_seg = (nx + 1 + seg_len - 1) / seg_len;
  const long long blocks =
      static_cast<long long>(parts) * n_seg * n_ty * n_tz;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(C);
  cudaError_t e = smv::allow_smem(matvec_v8_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  matvec_v8_kernel<<<static_cast<int>(blocks), kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(ck),
      static_cast<float*>(y), nx, ny, nz, C, n_ty, n_tz, n_seg);
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
extern "C" int structured_matvec_v8_stage_f32(const void* ke, int device,
                                              void* stream) {
  return smv::stage(ke_v8, ke, device, stream);
}

extern "C" int structured_matvec_v8_f32(const void* x, const void* ck,
                                        void* y, int parts, int nx, int ny,
                                        int nz, int planes, int device,
                                        void* stream) {
  smv::DeviceScope scope(device);
  if (scope.error() != 0) return scope.error();
  return launch(x, ck, y, parts, nx, ny, nz, planes,
                static_cast<cudaStream_t>(stream));
}

SMV_ERROR_STRING(structured_matvec_v8)
