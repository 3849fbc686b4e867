// Structured-slab block-stencil matvec for Hopper (sm_90a), float: flat
// lanes, each cell plane's product staged in shared memory.
//
// Replaces pcg_mpi_solver_tpu/ops/pallas_matvec.py::structured_matvec_pallas_v2
// (kernel _matvec_kernel_v2), which the JAX package's structured backend
// launches for every f32 matvec under PCG_TPU_PALLAS_V=2, and its per-part
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
// The TPU kernel flattens a node plane into m = (ny+1)(nz+1) lanes and
// indexes the cells at node strides (ck = 0 on the pad lanes), so corner a
// of the cell at lane q is the node at lane q + off_a, off_a in {0, 1,
// nz+1, nz+2}; per plane it does one (24,24)@(24,m) product V = Ke . (ck *
// U), then adds V's eight corner rows at those offsets, carrying the dx=1
// rows to the next plane.  Here:
//   * a block owns kLanes output lanes of one x segment and marches its
//     cell planes in a loop (the TPU's sequential grid); the dx=1 rows are
//     carried in registers, three per thread;
//   * per plane the two node planes are staged in shared memory over the
//     lanes the block needs, and each thread builds the 24 gathered values
//     of one cell lane from them at the flat offsets and multiplies by Ke
//     (constant bank, unrolled) - a column of T = ck * U is read only by
//     the thread that built it, so it stays in registers;
//   * V is what crosses lanes, so V is staged in shared memory: 24 rows
//     over the block's kLanes lanes and the nz+2 lanes before them, whose
//     cells also feed the block's nodes.  That halo is recomputed by the
//     block that owns it too (owner computes, no atomics: the same result
//     bit for bit run to run), which costs (kLanes + nz + 2) / kLanes of
//     the product's FMAs - 1.6x at 150^3;
//   * each thread then sums its own lane's eight corner rows of V;
//   * x is cut into segments of kSegment node planes for parallelism; a
//     segment first recomputes the carry of the cell plane before it.
// Shared memory: 4 * (6 * (kLanes + 2 nz + 4) + 24 * (kLanes + nz + 2))
// bytes, 52.6 KB at nz = 150; the launch is refused above 227 KB
// (nz above ~1,900).

#include <cuda_runtime.h>

#include "structured_common.cuh"

namespace {

using smv::corner_x;
using smv::corner_y;
using smv::corner_z;

constexpr int kLanes = 256;    // output lanes of a block, one per thread
constexpr int kSegment = 16;   // node planes a block finishes

__constant__ float ke_v2[24 * 24];

size_t smem_bytes(int nz) {
  const int sy = nz + 1;
  const int nq = kLanes + sy + 1, xw = nq + sy + 1;
  return sizeof(float) * (6 * static_cast<size_t>(xw) + 24 * nq);
}

__global__ void __launch_bounds__(kLanes)
matvec_v2_kernel(const float* __restrict__ x, const float* __restrict__ ck,
                 float* __restrict__ y, int nx, int ny, int nz, int n_tiles,
                 int n_seg) {
  extern __shared__ float smem[];
  const int nxn = nx + 1, nyn = ny + 1, nzn = nz + 1;
  const int sy = nzn, m = nyn * nzn, grid = nxn * m;
  int blk = blockIdx.x;
  const int tile = blk % n_tiles;
  blk /= n_tiles;
  const int seg = blk % n_seg;
  const int p = blk / n_seg;
  const float* xp = x + static_cast<size_t>(p) * 3 * grid;
  const float* ckp = ck + static_cast<size_t>(p) * nx * ny * nz;
  float* yp = y + static_cast<size_t>(p) * 3 * grid;
  const int tid = threadIdx.x;
  const int l0 = tile * kLanes;
  const int l = l0 + tid;                // this thread's output lane
  const int halo = sy + 1;               // cell lanes before the tile
  const int q0 = l0 - halo;              // first cell lane of the block
  const int nq = kLanes + halo;          // cell lanes per plane
  const int xw = nq + sy + 1;            // node lanes [q0, q0 + xw)
  float* xs = smem;                      // [2][3][xw]: node plane j in slot j&1
  float* vs = smem + 6 * xw;             // [24][nq]: V of one cell plane
  const int x0 = seg * kSegment;
  const int x1 = min(x0 + kSegment, nxn);

  auto stage_plane = [&](int px) {
    float* dst = xs + (px & 1) * 3 * xw;
    for (int k = tid; k < 3 * xw; k += kLanes) {
      const int c = k / xw, gl = q0 + k - c * xw;
      dst[k] = (px >= 0 && px < nxn && gl >= 0 && gl < m)
                   ? xp[c * grid + px * m + gl] : 0.f;
    }
  };

  stage_plane(x0 - 1);
  stage_plane(x0);
  __syncthreads();
  float carry[3] = {0.f, 0.f, 0.f};
  for (int i = x0 - 1; i < x1; ++i) {
    const bool plane_ok = i >= 0 && i < nx;   // the same for the block
    if (plane_ok) {
      const float* xa[2] = {xs + (i & 1) * 3 * xw, xs + ((i + 1) & 1) * 3 * xw};
      for (int q = tid; q < nq; q += kLanes) {
        const int gq = q0 + q;
        const int cy = gq >= 0 ? gq / sy : -1;
        const int cz = gq - cy * sy;
        if (gq >= 0 && cy < ny && cz < nz) {
          const float s = ckp[(i * ny + cy) * nz + cz];
          float u[24];
#pragma unroll
          for (int a = 0; a < 8; ++a) {
            const int off = corner_y(a) * sy + corner_z(a);
#pragma unroll
            for (int c = 0; c < 3; ++c)
              u[3 * a + c] = xa[corner_x(a)][c * xw + q + off];
          }
#pragma unroll
          for (int r = 0; r < 24; ++r) {
            float acc = 0.f;
#pragma unroll
            for (int e = 0; e < 24; ++e) acc += ke_v2[r * 24 + e] * u[e];
            vs[r * nq + q] = s * acc;
          }
        } else {
#pragma unroll
          for (int r = 0; r < 24; ++r) vs[r * nq + q] = 0.f;
        }
      }
    }
    __syncthreads();
    float lo[3] = {0.f, 0.f, 0.f}, hi[3] = {0.f, 0.f, 0.f};
    if (plane_ok) {
      // corner b of the cell at lane l - off_b is this thread's node
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const int qq = tid + halo - corner_y(b) * sy - corner_z(b);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float v = vs[(3 * b + c) * nq + qq];
          if (corner_x(b)) {
            hi[c] += v;
          } else {
            lo[c] += v;
          }
        }
      }
    }
    if (i >= x0 && l < m) {
#pragma unroll
      for (int c = 0; c < 3; ++c) yp[c * grid + i * m + l] = carry[c] + lo[c];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) carry[c] = hi[c];
    if (i + 1 < x1) {
      __syncthreads();        // V and the slot of plane i are free again
      stage_plane(i + 2);
      __syncthreads();
    }
  }
}

int launch(const void* x, const void* ck, void* y, int parts, int nx, int ny,
           int nz, cudaStream_t stream) {
  const int m = (ny + 1) * (nz + 1);
  const int n_tiles = (m + kLanes - 1) / kLanes;
  const int n_seg = (nx + 1 + kSegment - 1) / kSegment;
  const long long blocks = static_cast<long long>(parts) * n_seg * n_tiles;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(nz);
  cudaError_t e = smv::allow_smem(matvec_v2_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  matvec_v2_kernel<<<static_cast<int>(blocks), kLanes, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(ck),
      static_cast<float*>(y), nx, ny, nz, n_tiles, n_seg);
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
extern "C" int structured_matvec_v2_stage_f32(const void* ke, int device,
                                              void* stream) {
  return smv::stage(ke_v2, ke, device, stream);
}

extern "C" int structured_matvec_v2_f32(const void* x, const void* ck,
                                        void* y, int parts, int nx, int ny,
                                        int nz, int device, void* stream) {
  smv::DeviceScope scope(device);
  if (scope.error() != 0) return scope.error();
  return launch(x, ck, y, parts, nx, ny, nz,
                static_cast<cudaStream_t>(stream));
}

SMV_ERROR_STRING(structured_matvec_v2)
