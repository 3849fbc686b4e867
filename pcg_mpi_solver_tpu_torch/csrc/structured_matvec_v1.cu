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
// 28.7 us for the bytes at 3.35 TB/s), as for every variant.
//
// The TPU kernel marches one grid step per node plane and carries the
// cells' dx=1 partial sums to the next step in VMEM scratch.  Here the
// march is a loop inside each thread, the carry three registers:
//   * a thread owns one node column (iy, iz) of one x segment; for each
//     cell plane i it takes the rows of Ke that land on its node from the
//     <= 4 cells of that plane around it: the dx=0 corners finish node
//     plane i, the dx=1 corners are carried to node plane i+1 (576 FMAs per
//     node, no atomics, so the result is the same bit for bit run to run);
//   * x slides through registers: the 3x3 (y, z) neighbourhood of plane
//     i+1 is loaded once and reused as plane i at the next step, so each
//     thread loads 27 values per plane, not 81;
//   * only (ny+1)(nz+1) columns exist (22,801 at 150^3, ~178 blocks for 132
//     SMs), so x is cut into segments of kSegment node planes, one thread
//     per column and segment; a segment first recomputes the carry of the
//     cell plane before it (one plane in kSegment extra);
//   * Ke lives in the constant bank with every loop unrolled, so each Ke
//     entry is a constant-bank operand of its FMA;
//   * threads run fastest along z, so a warp's loads are contiguous.

#include <cuda_runtime.h>

#include "structured_common.cuh"

namespace {

using smv::corner_x;
using smv::corner_y;
using smv::corner_z;

constexpr int kThreads = 128;
constexpr int kSegment = 16;   // node planes a thread finishes

__constant__ float ke_v1[24 * 24];

// w[c][dy][dz] = x[c] at node (px, iy+dy-1, iz+dz-1), 0 off the grid.
__device__ __forceinline__ void load_plane(float (&w)[3][3][3],
                                           const float* __restrict__ xp,
                                           int px, int iy, int iz, int nxn,
                                           int nyn, int nzn, int grid) {
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int jy = iy + dy - 1;
#pragma unroll
    for (int dz = 0; dz < 3; ++dz) {
      const int jz = iz + dz - 1;
      const bool ok = px >= 0 && px < nxn && jy >= 0 && jy < nyn &&
                      jz >= 0 && jz < nzn;
      const int n = (px * nyn + jy) * nzn + jz;
#pragma unroll
      for (int c = 0; c < 3; ++c) w[c][dy][dz] = ok ? xp[c * grid + n] : 0.f;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
matvec_v1_kernel(const float* __restrict__ x, const float* __restrict__ ck,
                 float* __restrict__ y, int nx, int ny, int nz, int n_seg,
                 int n_threads_total) {
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  if (tid >= n_threads_total) return;
  const int nxn = nx + 1, nyn = ny + 1, nzn = nz + 1;
  const int iz = tid % nzn;
  int t = tid / nzn;
  const int iy = t % nyn;
  t /= nyn;
  const int seg = t % n_seg;
  const int p = t / n_seg;
  const int grid = nxn * nyn * nzn;
  const float* xp = x + static_cast<size_t>(p) * 3 * grid;
  const float* ckp = ck + static_cast<size_t>(p) * nx * ny * nz;
  float* yp = y + static_cast<size_t>(p) * 3 * grid + iy * nzn + iz;
  const int x0 = seg * kSegment;
  const int x1 = min(x0 + kSegment, nxn);

  // the cells of one plane around this node: (iy - ey, iz - ez)
  bool cell_ok[2][2];
#pragma unroll
  for (int ey = 0; ey < 2; ++ey)
#pragma unroll
    for (int ez = 0; ez < 2; ++ez)
      cell_ok[ey][ez] = iy - ey >= 0 && iy - ey < ny && iz - ez >= 0 &&
                        iz - ez < nz;

  // w[s] holds node plane i + s
  float w[2][3][3][3];
  load_plane(w[0], xp, x0 - 1, iy, iz, nxn, nyn, nzn, grid);
  load_plane(w[1], xp, x0, iy, iz, nxn, nyn, nzn, grid);
  float carry0 = 0.f, carry1 = 0.f, carry2 = 0.f;

  for (int i = x0 - 1; i < x1; ++i) {
    float lo[3] = {0.f, 0.f, 0.f}, hi[3] = {0.f, 0.f, 0.f};
    if (i >= 0 && i < nx) {
      float s[2][2];
#pragma unroll
      for (int ey = 0; ey < 2; ++ey)
#pragma unroll
        for (int ez = 0; ez < 2; ++ez)
          s[ey][ez] = cell_ok[ey][ez]
                          ? ckp[(i * ny + iy - ey) * nz + iz - ez] : 0.f;
      // this node is corner b of the cell (i, iy - ey(b), iz - ez(b))
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const int ey = corner_y(b), ez = corner_z(b);
        if (!cell_ok[ey][ez]) continue;
        float t0 = 0.f, t1 = 0.f, t2 = 0.f;
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          const int ax = corner_x(a);
          const int oy = corner_y(a) - ey + 1, oz = corner_z(a) - ez + 1;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float v = w[ax][c][oy][oz];
            const int col = 3 * a + c;
            t0 += ke_v1[(3 * b + 0) * 24 + col] * v;
            t1 += ke_v1[(3 * b + 1) * 24 + col] * v;
            t2 += ke_v1[(3 * b + 2) * 24 + col] * v;
          }
        }
        const float sc = s[ey][ez];
        if (corner_x(b)) {
          hi[0] += sc * t0;
          hi[1] += sc * t1;
          hi[2] += sc * t2;
        } else {
          lo[0] += sc * t0;
          lo[1] += sc * t1;
          lo[2] += sc * t2;
        }
      }
    }
    if (i >= x0) {
      float* yi = yp + i * nyn * nzn;
      yi[0] = carry0 + lo[0];
      yi[grid] = carry1 + lo[1];
      yi[2 * grid] = carry2 + lo[2];
    }
    carry0 = hi[0];
    carry1 = hi[1];
    carry2 = hi[2];
    if (i + 1 < x1) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dz = 0; dz < 3; ++dz) w[0][c][dy][dz] = w[1][c][dy][dz];
      load_plane(w[1], xp, i + 2, iy, iz, nxn, nyn, nzn, grid);
    }
  }
}

int launch(const void* x, const void* ck, void* y, int parts, int nx, int ny,
           int nz, cudaStream_t stream) {
  const int n_seg = (nx + 1 + kSegment - 1) / kSegment;
  const long long total =
      static_cast<long long>(parts) * n_seg * (ny + 1) * (nz + 1);
  if (total >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>((total + kThreads - 1) / kThreads);
  matvec_v1_kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(ck),
      static_cast<float*>(y), nx, ny, nz, n_seg, static_cast<int>(total));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points.  stage copies ke (24,24), a contiguous float device
// buffer, into this library's constant bank on `device`.  The matvec takes
// x (P,3,nx+1,ny+1,nz+1) and ck (P,nx,ny,nz), contiguous float device
// buffers, and writes y, allocated by the caller with x's shape, using the
// Ke staged last.  The wrapper (ops/structured_matvec.py) checks shapes,
// dtype and contiguity and keeps every index below 2^31.  Each returns the
// CUDA error code of its copy or launch (0 = done / launched).
extern "C" int structured_matvec_v1_stage_f32(const void* ke, int device,
                                              void* stream) {
  return smv::stage(ke_v1, ke, device, stream);
}

extern "C" int structured_matvec_v1_f32(const void* x, const void* ck,
                                        void* y, int parts, int nx, int ny,
                                        int nz, int device, void* stream) {
  smv::DeviceScope scope(device);
  if (scope.error() != 0) return scope.error();
  return launch(x, ck, y, parts, nx, ny, nz,
                static_cast<cudaStream_t>(stream));
}

SMV_ERROR_STRING(structured_matvec_v1)
