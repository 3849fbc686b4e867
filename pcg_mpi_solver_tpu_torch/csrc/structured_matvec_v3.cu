// Structured-slab block-stencil matvec for Hopper (sm_90a), float: chunks
// of cell planes, double-buffered in shared memory with asynchronous
// copies.
//
// Replaces pcg_mpi_solver_tpu/ops/pallas_matvec.py::structured_matvec_pallas_v3
// (kernel _matvec_kernel_v3), which the JAX package's structured backend
// launches for every f32 matvec under PCG_TPU_PALLAS_V=3, and its per-part
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
// The TPU kernel takes C = PCG_TPU_PALLAS_PLANES cell planes per grid step
// and starts the DMA of the next chunk before it computes this one.  A TPU
// core's VMEM holds whole planes; a Hopper block has 227 KB of shared
// memory and one node plane at 150^3 is 273 KB, so here:
//   * a block owns a kTy x kTz tile of output nodes in (y, z) over one x
//     segment of kChunks * C - 1 node planes, and marches the segment's
//     cell planes in chunks of C: a chunk stages C + 1 node planes of the
//     tile plus a one-node halo, 3 x (C+1) x (kTy+2) x (kTz+2) values, and
//     the C x (kTy+1) x (kTz+1) cell scales around it;
//   * the stages form a two-slot ring filled by cp.async (4 bytes a value,
//     zero-filled off the grid): chunk k+1's copies are in flight while
//     chunk k computes;
//   * within a chunk each thread owns one node and works as the x-march of
//     v1 does, reading shared memory: per cell plane the rows of Ke that
//     land on its node from the <= 4 cells around it, dx=0 rows finishing
//     this node plane, dx=1 rows carried in registers to the next (576
//     FMAs a node, no atomics: the same result bit for bit run to run);
//   * the first cell plane of a segment only recomputes the carry into it;
//     the last chunk of the last segment is ragged and masked: node planes
//     past nx are zero-filled, cell planes past nx - 1 are skipped;
//   * Ke lives in the constant bank with every loop unrolled.
// Shared memory: two stages of 4 * (3 (C+1) (kTy+2)(kTz+2) + C (kTy+1)
// (kTz+1)) bytes, 92.4 KB at C = 8 and 176.7 KB at C = 16; the launch is
// refused above 227 KB (C above 20).

#include <cuda_runtime.h>

#include "structured_common.cuh"

namespace {

using smv::copy4;
using smv::corner_x;
using smv::corner_y;
using smv::corner_z;

constexpr int kTy = 8, kTz = 32;        // node tile: a warp per y row
constexpr int kThreads = kTy * kTz;
constexpr int kNy = kTy + 2, kNz = kTz + 2;   // staged nodes (with halo)
constexpr int kCy = kTy + 1, kCz = kTz + 1;   // staged cells
constexpr int kChunks = 4;              // chunks per segment

__constant__ float ke_v3[24 * 24];

int stage_floats(int C) { return 3 * (C + 1) * kNy * kNz + C * kCy * kCz; }

__global__ void __launch_bounds__(kThreads)
matvec_v3_kernel(const float* __restrict__ x, const float* __restrict__ ck,
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
  const int tid = threadIdx.x;
  const int ty = tid / kTz, tz = tid % kTz;
  const int iy = iy0 + ty, iz = iz0 + tz;
  const bool node_ok = iy < nyn && iz < nzn;
  float* yp = y + static_cast<size_t>(p) * 3 * grid + iy * nzn + iz;

  const int seg_len = kChunks * C - 1;
  const int x0 = seg * seg_len;
  const int x_end = min(x0 + seg_len, nxn);
  // cell planes x0-1 .. x_end-1, C a chunk
  const int n_chunks = (x_end - x0 + C) / C;
  const int xs_floats = 3 * (C + 1) * kNy * kNz;
  const int st_floats = xs_floats + C * kCy * kCz;

  // stage [c][r][yy][zz] holds node (pbase + r, iy0 - 1 + yy, iz0 - 1 + zz),
  // then [r][yy][zz] the cell (pbase + r, iy0 - 1 + yy, iz0 - 1 + zz)
  auto issue = [&](int k) {
    float* xs = smem + (k & 1) * st_floats;
    float* cs = xs + xs_floats;
    const int pbase = x0 - 1 + k * C;
    for (int e = tid; e < xs_floats; e += kThreads) {
      const int zz = e % kNz;
      int t = e / kNz;
      const int yy = t % kNy;
      t /= kNy;
      const int r = t % (C + 1), c = t / (C + 1);
      const int gp = pbase + r, gy = iy0 - 1 + yy, gz = iz0 - 1 + zz;
      const bool ok = gp >= 0 && gp < nxn && gy >= 0 && gy < nyn &&
                      gz >= 0 && gz < nzn;
      copy4(xs + e, ok ? xp + c * grid + (gp * nyn + gy) * nzn + gz : xp, ok);
    }
    for (int e = tid; e < C * kCy * kCz; e += kThreads) {
      const int zz = e % kCz;
      const int t = e / kCz;
      const int yy = t % kCy, r = t / kCy;
      const int gi = pbase + r, gy = iy0 - 1 + yy, gz = iz0 - 1 + zz;
      const bool ok = gi >= 0 && gi < nx && gy >= 0 && gy < ny && gz >= 0 &&
                      gz < nz;
      copy4(cs + e, ok ? ckp + (gi * ny + gy) * nz + gz : ckp, ok);
    }
    smv::commit_copies();
  };

  // the cells around this node: (iy - ey, iz - ez)
  bool cell_ok[2][2];
#pragma unroll
  for (int ey = 0; ey < 2; ++ey)
#pragma unroll
    for (int ez = 0; ez < 2; ++ez)
      cell_ok[ey][ez] = iy - ey >= 0 && iy - ey < ny && iz - ez >= 0 &&
                        iz - ez < nz;

  float carry[3] = {0.f, 0.f, 0.f};
  issue(0);
  for (int k = 0; k < n_chunks; ++k) {
    if (k + 1 < n_chunks) {
      issue(k + 1);
      smv::wait_copies<1>();
    } else {
      smv::wait_copies<0>();
    }
    __syncthreads();
    const float* xs = smem + (k & 1) * st_floats;
    const float* cs = xs + xs_floats;
    const int pbase = x0 - 1 + k * C;
    for (int r = 0; r < C && pbase + r < x_end; ++r) {
      const int i = pbase + r;
      float lo[3] = {0.f, 0.f, 0.f}, hi[3] = {0.f, 0.f, 0.f};
      if (i >= 0 && i < nx) {
        // this node is corner b of the cell (i, iy - ey(b), iz - ez(b))
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const int ey = corner_y(b), ez = corner_z(b);
          if (!cell_ok[ey][ez]) continue;
          float t0 = 0.f, t1 = 0.f, t2 = 0.f;
#pragma unroll
          for (int a = 0; a < 8; ++a) {
            const int yy = ty + 1 - ey + corner_y(a);
            const int zz = tz + 1 - ez + corner_z(a);
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              const float v =
                  xs[((c * (C + 1) + r + corner_x(a)) * kNy + yy) * kNz + zz];
              const int col = 3 * a + c;
              t0 += ke_v3[(3 * b + 0) * 24 + col] * v;
              t1 += ke_v3[(3 * b + 1) * 24 + col] * v;
              t2 += ke_v3[(3 * b + 2) * 24 + col] * v;
            }
          }
          const float s = cs[(r * kCy + ty + 1 - ey) * kCz + tz + 1 - ez];
          if (corner_x(b)) {
            hi[0] += s * t0;
            hi[1] += s * t1;
            hi[2] += s * t2;
          } else {
            lo[0] += s * t0;
            lo[1] += s * t1;
            lo[2] += s * t2;
          }
        }
      }
      if (i >= x0 && node_ok) {
        float* yi = yp + i * nyn * nzn;
        yi[0] = carry[0] + lo[0];
        yi[grid] = carry[1] + lo[1];
        yi[2 * grid] = carry[2] + lo[2];
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) carry[c] = hi[c];
    }
    __syncthreads();          // this slot is refilled by chunk k + 2
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
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(stage_floats(C));
  cudaError_t e = smv::allow_smem(matvec_v3_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  matvec_v3_kernel<<<static_cast<int>(blocks), kThreads, smem, stream>>>(
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
extern "C" int structured_matvec_v3_stage_f32(const void* ke, int device,
                                              void* stream) {
  return smv::stage(ke_v3, ke, device, stream);
}

extern "C" int structured_matvec_v3_f32(const void* x, const void* ck,
                                        void* y, int parts, int nx, int ny,
                                        int nz, int planes, int device,
                                        void* stream) {
  smv::DeviceScope scope(device);
  if (scope.error() != 0) return scope.error();
  return launch(x, ck, y, parts, nx, ny, nz, planes,
                static_cast<cudaStream_t>(stream));
}

SMV_ERROR_STRING(structured_matvec_v3)
