// Structured-slab block-stencil matvec for Hopper (sm_90a), float and double.
//
// Replaces pcg_mpi_solver_tpu/ops/pallas_matvec.py::structured_matvec_pallas_v6
// (the TPU kernel the JAX package's structured backend launches for every
// f32 matvec) and its per-part dispatch loop batched_structured_matvec: one
// launch here covers the whole leading part axis.  The double instantiation
// also takes the f64 matvecs the JAX package left to XLA (Dirichlet lifting,
// the refinement refreshes of pcg_mixed, every matvec of a direct f64 solve),
// whichever variant PCG_TPU_PALLAS_V selects for float.
//
// Function (StructuredOps.matvec_local, one slab per part p):
//   y[p] = sum_b shift_b( sum_a Ke[3b:3b+3, 3a:3a+3] . (ck[p] * x[p]_a) )
// x, y: (P, 3, nx+1, ny+1, nz+1) component-major node grids; ck: (P, nx, ny,
// nz) per-cell stiffness scales; Ke: (24, 24) unit element stiffness in
// element-dof order 3*corner + comp, corners in VTK hexahedron order.
//
// What bounds it on an H100 SXM: per cell it does 24*24 = 576 FMAs and moves
// about 28 bytes in float (x and y once per node, ck once per cell).  At the
// flagship 150^3 slab that is 3.9 GFLOP against ~96 MB: 58 us at the
// 67 TFLOP/s FP32 CUDA-core rate against 29 us at 3.35 TB/s, so the
// operations bound it (double: 114 us at 34 TFLOP/s against 57 us).  The
// work is a (24 x 24) product per cell - too narrow for the tensor cores to
// pay off in a first kernel - so the design spends its effort on keeping
// every FMA an FMA and nothing else:
//   * one thread per output node gathers from its <= 8 neighbouring cells:
//     no atomics, so the result is deterministic, bit for bit, run to run;
//   * Ke lives in the __constant__ bank and every loop over cells, corners
//     and components is unrolled, so each Ke entry is a compile-time
//     constant-bank operand of its FMA - no load instruction per FMA;
//   * the node's 3x3x3 neighbourhood (81 values) is loaded into registers
//     once, not once per cell (192 loads);
//   * threads run fastest along z, so a warp's loads are contiguous.
// Nothing of v6's slab DMA, host padding or lane rolls is carried over:
// those exist for the TPU's (8, 128) tiling.
//
// Ke is staged into the constant bank by its own entry point, once per Ke:
// the wrapper (ops/structured_matvec.py) restages only when it is handed
// another Ke tensor or the same one changed in place.  Staging ends with a
// stream sync, so every later launch on any stream reads the new Ke; a
// launch with one Ke must not still be running when another Ke is staged.
// The entry points make the tensor's device current for their calls and
// restore the caller's device before they return.

#include <cuda_runtime.h>

#include "structured_common.cuh"

namespace {

using smv::corner_x;
using smv::corner_y;
using smv::corner_z;

constexpr int kThreads = 128;

__constant__ float ke_f32[24 * 24];
__constant__ double ke_f64[24 * 24];

template <typename T> __device__ __forceinline__ T ke(int i);
template <> __device__ __forceinline__ float ke<float>(int i) { return ke_f32[i]; }
template <> __device__ __forceinline__ double ke<double>(int i) { return ke_f64[i]; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
structured_matvec_kernel(const T* __restrict__ x, const T* __restrict__ ck,
                         T* __restrict__ y, int nx, int ny, int nz,
                         int n_nodes_total) {
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  if (tid >= n_nodes_total) return;
  const int nxn = nx + 1, nyn = ny + 1, nzn = nz + 1;
  const int iz = tid % nzn;
  int t = tid / nzn;
  const int iy = t % nyn;
  t /= nyn;
  const int ix = t % nxn;
  const int p = t / nxn;
  const int grid = nxn * nyn * nzn;            // nodes of one component grid
  const int node = tid - p * grid;
  const T* xp = x + static_cast<size_t>(p) * 3 * grid;
  const T* ckp = ck + static_cast<size_t>(p) * nx * ny * nz;

  // u[c][dx][dy][dz] = x[c] at node (ix+dx-1, iy+dy-1, iz+dz-1).  A node off
  // the grid reads 0: it belongs only to cells off the grid, skipped below.
  T u[3][3][3][3];
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    const int jx = ix + dx - 1;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int jy = iy + dy - 1;
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
        const int jz = iz + dz - 1;
        const bool ok = jx >= 0 && jx < nxn && jy >= 0 && jy < nyn &&
                        jz >= 0 && jz < nzn;
        const int n = (jx * nyn + jy) * nzn + jz;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          u[c][dx][dy][dz] = ok ? xp[c * grid + n] : T(0);
        }
      }
    }
  }

  T acc0 = T(0), acc1 = T(0), acc2 = T(0);
  // This node is corner b of the cell at (ix, iy, iz) - offset(b).
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const int cx = ix - corner_x(b), cy = iy - corner_y(b),
              cz = iz - corner_z(b);
    if (cx < 0 || cx >= nx || cy < 0 || cy >= ny || cz < 0 || cz >= nz) {
      continue;
    }
    T t0 = T(0), t1 = T(0), t2 = T(0);
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int ox = corner_x(a) - corner_x(b) + 1;
      const int oy = corner_y(a) - corner_y(b) + 1;
      const int oz = corner_z(a) - corner_z(b) + 1;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const T v = u[c][ox][oy][oz];
        const int col = 3 * a + c;
        t0 += ke<T>((3 * b + 0) * 24 + col) * v;
        t1 += ke<T>((3 * b + 1) * 24 + col) * v;
        t2 += ke<T>((3 * b + 2) * 24 + col) * v;
      }
    }
    // ck is per cell, the same for all 24 gathered values: scale once
    const T s = ckp[(cx * ny + cy) * nz + cz];
    acc0 += s * t0;
    acc1 += s * t1;
    acc2 += s * t2;
  }
  T* yp = y + static_cast<size_t>(p) * 3 * grid + node;
  yp[0] = acc0;
  yp[grid] = acc1;
  yp[2 * grid] = acc2;
}

template <typename T>
int launch(const void* x, const void* ck, void* y, int parts, int nx, int ny,
           int nz, cudaStream_t stream) {
  const long long total =
      static_cast<long long>(parts) * (nx + 1) * (ny + 1) * (nz + 1);
  const int blocks = static_cast<int>((total + kThreads - 1) / kThreads);
  structured_matvec_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(ck), static_cast<T*>(y),
      nx, ny, nz, static_cast<int>(total));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_on(const void* x, const void* ck, void* y, int parts, int nx,
              int ny, int nz, int device, void* stream) {
  smv::DeviceScope scope(device);
  if (scope.error() != 0) return scope.error();
  return launch<T>(x, ck, y, parts, nx, ny, nz,
                   static_cast<cudaStream_t>(stream));
}

}  // namespace

// C entry points, two per dtype.  stage copies ke (24,24), a contiguous
// device buffer of the entry's dtype, into the constant bank of `device`.
// The matvec takes x (P,3,nx+1,ny+1,nz+1) and ck (P,nx,ny,nz), contiguous
// device buffers of the entry's dtype, and writes y, allocated by the caller
// with x's shape, using the Ke staged last.  The wrapper checks shapes,
// dtype and contiguity and keeps every index below 2^31.  Each returns the
// CUDA error code of its copy or launch (0 = done / launched).
extern "C" int structured_matvec_stage_f32(const void* ke, int device,
                                           void* stream) {
  return smv::stage(ke_f32, ke, device, stream);
}

extern "C" int structured_matvec_stage_f64(const void* ke, int device,
                                           void* stream) {
  return smv::stage(ke_f64, ke, device, stream);
}

extern "C" int structured_matvec_f32(const void* x, const void* ck, void* y,
                                     int parts, int nx, int ny, int nz,
                                     int device, void* stream) {
  return launch_on<float>(x, ck, y, parts, nx, ny, nz, device, stream);
}

extern "C" int structured_matvec_f64(const void* x, const void* ck, void* y,
                                     int parts, int nx, int ny, int nz,
                                     int device, void* stream) {
  return launch_on<double>(x, ck, y, parts, nx, ny, nz, device, stream);
}

SMV_ERROR_STRING(structured_matvec)
