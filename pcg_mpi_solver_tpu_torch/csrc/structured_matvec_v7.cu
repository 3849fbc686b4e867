// Structured-slab block-stencil matvec for Hopper (sm_90a), float: lane
// shifts by register exchange (warp shuffles).
//
// Replaces pcg_mpi_solver_tpu/ops/pallas_matvec.py::structured_matvec_pallas_v7
// (kernel _matvec_kernel_v7), which the JAX package's structured backend
// launches for every f32 matvec under PCG_TPU_PALLAS_V=7, and its per-part
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
// The TPU kernel never reads at an unaligned lane offset: every gather and
// every output placement is a rotation of a whole row (pltpu.roll), and
// the host pads x and ck so the zero tail of ck kills the wrap.  The
// Hopper reading of a row rotation is a warp shuffle:
//   * a warp owns 32 consecutive z nodes of one y row and one x segment
//     of C = PCG_TPU_PALLAS_PLANES node planes, and marches x in a loop;
//     lane l loads only its own node's values, in the three y rows
//     iy-1, iy, iy+1 (y is wider than a warp, so dy goes through loads),
//     once per plane;
//   * lane l computes the cells (iy-1, z) and (iy, z) of its own z: their
//     z+1 corners come from lane l+1 by __shfl_down_sync;
//   * of each cell it takes the 12 rows of Ke whose corner lies in row iy
//     (576 FMAs a node, none repeated); the rows of corners at z go to its
//     own node, those at z+1 go to lane l+1 by __shfl_up_sync, and the
//     dx=1 rows are carried to the next node plane in registers;
//   * lane 0 misses the z-1 cells' rows and lane 31 the z+1 values, so
//     warps overlap by two lanes and only lanes 1..30 write (owner
//     recompute, no atomics: the same result bit for bit run to run);
//   * nothing is padded on the host: loads off the grid read 0 and cells
//     off the grid are skipped;
//   * Ke lives in the constant bank with every loop unrolled.

#include <cuda_runtime.h>

#include "structured_common.cuh"

namespace {

using smv::corner_x;
using smv::corner_y;
using smv::corner_z;

constexpr int kThreads = 128;
constexpr int kOwn = 30;            // z nodes a warp finishes: lanes 1..30
constexpr unsigned kAll = 0xffffffffu;

__constant__ float ke_v7[24 * 24];

// own[c][r] = x[c] at node (px, iy+r-1, iz), 0 off the grid; nxt the same
// at iz+1, from the next lane
__device__ __forceinline__ void load_plane(float (&own)[3][3],
                                           float (&nxt)[3][3],
                                           const float* __restrict__ xp,
                                           int px, int iy, int iz, int nxn,
                                           int nyn, int nzn, int grid) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int jy = iy + r - 1;
    const bool ok = px >= 0 && px < nxn && jy >= 0 && jy < nyn && iz >= 0 &&
                    iz < nzn;
    const int n = (px * nyn + jy) * nzn + iz;
#pragma unroll
    for (int c = 0; c < 3; ++c) own[c][r] = ok ? xp[c * grid + n] : 0.f;
  }
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) nxt[c][r] = __shfl_down_sync(kAll, own[c][r], 1);
}

__global__ void __launch_bounds__(kThreads)
matvec_v7_kernel(const float* __restrict__ x, const float* __restrict__ ck,
                 float* __restrict__ y, int nx, int ny, int nz, int C,
                 int n_seg, int n_zw, int n_warps) {
  const int warp = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  if (warp >= n_warps) return;              // whole warps only
  const int lane = threadIdx.x & 31;
  const int nxn = nx + 1, nyn = ny + 1, nzn = nz + 1;
  const int grid = nxn * nyn * nzn;
  const int zw = warp % n_zw;
  int t = warp / n_zw;
  const int iy = t % nyn;
  t /= nyn;
  const int seg = t % n_seg;
  const int p = t / n_seg;
  const int iz = zw * kOwn - 1 + lane;
  const bool owner = lane >= 1 && lane <= kOwn && iz < nzn;
  const float* xp = x + static_cast<size_t>(p) * 3 * grid;
  const float* ckp = ck + static_cast<size_t>(p) * nx * ny * nz;
  float* yp = y + static_cast<size_t>(p) * 3 * grid + iy * nzn + iz;
  const int x0 = seg * C;
  const int x1 = min(x0 + C, nxn);

  // the cells (iy - 1 + ry, iz) this lane computes
  bool cell_ok[2];
#pragma unroll
  for (int ry = 0; ry < 2; ++ry)
    cell_ok[ry] = iy - 1 + ry >= 0 && iy - 1 + ry < ny && iz >= 0 && iz < nz;

  // own[s], nxt[s]: node plane i + s at z = iz and iz + 1
  float own[2][3][3], nxt[2][3][3];
  load_plane(own[0], nxt[0], xp, x0 - 1, iy, iz, nxn, nyn, nzn, grid);
  load_plane(own[1], nxt[1], xp, x0, iy, iz, nxn, nyn, nzn, grid);
  float carry[3] = {0.f, 0.f, 0.f};

  for (int i = x0 - 1; i < x1; ++i) {
    // [dx] partial sums for this lane's node (z) and for the next (z+1)
    float here[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
    float up[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
    if (i >= 0 && i < nx) {
#pragma unroll
      for (int ry = 0; ry < 2; ++ry) {
        if (!cell_ok[ry]) continue;
        const float s = ckp[(i * ny + iy - 1 + ry) * nz + iz];
        // node row iy is corner row ey = 1 - ry of this cell
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          if (corner_y(b) != 1 - ry) continue;
          float t0 = 0.f, t1 = 0.f, t2 = 0.f;
#pragma unroll
          for (int a = 0; a < 8; ++a) {
            const int ax = corner_x(a), r = ry + corner_y(a);
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              const float v = corner_z(a) ? nxt[ax][c][r] : own[ax][c][r];
              const int col = 3 * a + c;
              t0 += ke_v7[(3 * b + 0) * 24 + col] * v;
              t1 += ke_v7[(3 * b + 1) * 24 + col] * v;
              t2 += ke_v7[(3 * b + 2) * 24 + col] * v;
            }
          }
          const int dx = corner_x(b);
          if (corner_z(b)) {
            up[dx][0] += s * t0;
            up[dx][1] += s * t1;
            up[dx][2] += s * t2;
          } else {
            here[dx][0] += s * t0;
            here[dx][1] += s * t1;
            here[dx][2] += s * t2;
          }
        }
      }
    }
    // the z+1 rows of lane l-1's cells belong to this lane's node
#pragma unroll
    for (int d = 0; d < 2; ++d)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        here[d][c] += __shfl_up_sync(kAll, up[d][c], 1);
    if (i >= x0 && owner) {
      float* yi = yp + i * nyn * nzn;
      yi[0] = carry[0] + here[0][0];
      yi[grid] = carry[1] + here[0][1];
      yi[2 * grid] = carry[2] + here[0][2];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) carry[c] = here[1][c];
    if (i + 1 < x1) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          own[0][c][r] = own[1][c][r];
          nxt[0][c][r] = nxt[1][c][r];
        }
      load_plane(own[1], nxt[1], xp, i + 2, iy, iz, nxn, nyn, nzn, grid);
    }
  }
}

int launch(const void* x, const void* ck, void* y, int parts, int nx, int ny,
           int nz, int planes, cudaStream_t stream) {
  const int C = max(1, min(planes, nx + 1));
  const int n_seg = (nx + 1 + C - 1) / C;
  const int n_zw = (nz + 1 + kOwn - 1) / kOwn;
  const long long warps =
      static_cast<long long>(parts) * n_seg * (ny + 1) * n_zw;
  if (warps * 32 >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>((warps * 32 + kThreads - 1) / kThreads);
  matvec_v7_kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(ck),
      static_cast<float*>(y), nx, ny, nz, C, n_seg, n_zw,
      static_cast<int>(warps));
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
extern "C" int structured_matvec_v7_stage_f32(const void* ke, int device,
                                              void* stream) {
  return smv::stage(ke_v7, ke, device, stream);
}

extern "C" int structured_matvec_v7_f32(const void* x, const void* ck,
                                        void* y, int parts, int nx, int ny,
                                        int nz, int planes, int device,
                                        void* stream) {
  smv::DeviceScope scope(device);
  if (scope.error() != 0) return scope.error();
  return launch(x, ck, y, parts, nx, ny, nz, planes,
                static_cast<cudaStream_t>(stream));
}

SMV_ERROR_STRING(structured_matvec_v7)
