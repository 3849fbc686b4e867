// Structured-slab block-stencil matvec for Hopper (sm_90a), float: nodes
// staged as float4 (x, y, z, 0), the cell product accumulated over input
// corners, ck applied once, corner blocks extracted as register selects.
//
// Replaces pcg_mpi_solver_tpu/ops/pallas_matvec.py::structured_matvec_pallas_v9
// (kernel _matvec_kernel_v9), which the JAX package's structured backend
// launches for every f32 matvec under PCG_TPU_PALLAS_V=9, and its per-part
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
// The TPU kernel reads a plane-major slab (planes, 4, lanes) with a dead
// 4th component, so a corner read is one whole block; it never builds the
// gathered (24, m) array but accumulates v = sum_a Ke[:, 3a:3a+3] . x_a
// over the eight input corners (eight (24,3) dots), scales v by ck once,
// extracts each output corner's 3 rows by a one-hot (3,24) dot, rotates
// them to their lane offset and adds them, carrying dx = 1 rows to the
// next plane; chunks of C = PCG_TPU_PALLAS_PLANES cell planes (C + 1 node
// planes) are double-buffered.  The host pads and transposes x into that
// layout, one more round trip of x per matvec.  Here, with no host pad or
// transpose (the layout lives in shared memory only):
//   * a block of kCy x kCz threads owns one cell each of a kCy x kCz cell
//     tile, (iy0 - 1 .. iy0 + kCy - 2, iz0 - 1 .. iz0 + kCz - 2), and the
//     (kCy-1) x (kCz-1) node tile those cells surround (every cell of an
//     owned node is in the tile; the outer ring of nodes belongs to the
//     neighbouring blocks, which compute those cells again: 1.18x the
//     product's FMAs, no atomics), over one x segment of kChunks * C - 1
//     node planes;
//   * a chunk's C + 1 node planes of the tile and its halo are staged
//     plane-major as float4 (x, y, z, 0) - three 4-byte cp.asyncs a node,
//     zero-filled off the grid, the 4th lane zeroed once - in a two-slot
//     ring: chunk k + 1's copies are in flight while chunk k computes, and
//     a corner read is one 16-byte shared load;
//   * per cell plane each thread accumulates its cell's 24-vector over the
//     eight input corners (3 x 24 FMAs each, so the gathered 24 values are
//     never held), scales it once by ck, and places output corner b's
//     three values - register selects v[3b .. 3b+2], not products - into
//     two shared node accumulators over the owned tile, one per node plane
//     (slot i & 1 for node plane i: dx = 0 rows to this plane, dx = 1 rows
//     to the next, the carry).  The eight placements are separated by
//     __syncthreads; each maps cells one to one onto nodes, so no two
//     threads add to one value and the sum order is fixed (the same result
//     bit for bit run to run);
//   * a node plane is written once its last cell plane is placed, z
//     fastest, and its slot zeroed; a segment first recomputes the carry
//     of the cell plane before it; node planes past nx are zero-filled,
//     cell planes past nx - 1 skipped;
//   * Ke lives in the constant bank with every loop unrolled.
// Shared memory: 2 (C+1) (kCy+1)(kCz+1) float4 + 2 * 3 (kCy-1)(kCz-1)
// floats, 88.6 KB at C = 8 and 162.9 KB at C = 16; the launch is refused
// above 227 KB (C above 22).

#include <cuda_runtime.h>

#include "structured_common.cuh"

namespace {

using smv::copy4;
using smv::corner_x;
using smv::corner_y;
using smv::corner_z;

constexpr int kCy = 8, kCz = 32;              // cell tile: a thread a cell
constexpr int kThreads = kCy * kCz;
constexpr int kTy = kCy - 1, kTz = kCz - 1;   // owned node tile
constexpr int kNy = kCy + 1, kNz = kCz + 1;   // staged node tile
constexpr int kChunks = 2;                    // chunks per segment

__constant__ float ke_v9[24 * 24];

size_t smem_bytes(int C) {
  return sizeof(float4) * 2 * (C + 1) * static_cast<size_t>(kNy * kNz) +
         sizeof(float) * 2 * 3 * kTy * kTz;
}

__global__ void __launch_bounds__(kThreads)
matvec_v9_kernel(const float* __restrict__ x, const float* __restrict__ ck,
                 float* __restrict__ y, int nx, int ny, int nz, int C,
                 int n_ty, int n_tz, int n_seg) {
  extern __shared__ float4 smem4[];
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
  // the node this thread writes: (iy0 + ty, iz0 + tz) of the owned tile
  const bool writer = ty < kTy && tz < kTz && iy0 + ty < nyn &&
                      iz0 + tz < nzn;

  const int seg_len = kChunks * C - 1;
  const int x0 = seg * seg_len;
  const int x_end = min(x0 + seg_len, nxn);
  // cell planes x0-1 .. x_end-1, C a chunk
  const int n_chunks = (x_end - x0 + C) / C;
  const int slot = (C + 1) * kNy * kNz;       // float4 a ring slot
  // acc [node plane & 1][comp][oy][oz]: node (i, iy0 + oy, iz0 + oz)
  float* acc = reinterpret_cast<float*>(smem4 + 2 * slot);
  constexpr int kOut = kTy * kTz;

  // slot [r][yy][zz] holds node (pbase + r, iy0 - 1 + yy, iz0 - 1 + zz)
  auto issue = [&](int k) {
    float4* xs = smem4 + (k & 1) * slot;
    const int pbase = x0 - 1 + k * C;
    for (int e = tid; e < slot; e += kThreads) {
      const int zz = e % kNz;
      const int t = e / kNz;
      const int yy = t % kNy, r = t / kNy;
      const int gp = pbase + r, gy = iy0 - 1 + yy, gz = iz0 - 1 + zz;
      const bool ok = gp >= 0 && gp < nxn && gy >= 0 && gy < nyn &&
                      gz >= 0 && gz < nzn;
      const float* src = ok ? xp + (gp * nyn + gy) * nzn + gz : xp;
      float* dst = &xs[e].x;
#pragma unroll
      for (int c = 0; c < 3; ++c) copy4(dst + c, ok ? src + c * grid : xp, ok);
    }
    smv::commit_copies();
  };

  for (int e = tid; e < 2 * slot; e += kThreads) smem4[e].w = 0.f;
  for (int e = tid; e < 2 * 3 * kOut; e += kThreads) acc[e] = 0.f;
  issue(0);
  for (int k = 0; k < n_chunks; ++k) {
    if (k + 1 < n_chunks) {
      issue(k + 1);
      smv::wait_copies<1>();
    } else {
      smv::wait_copies<0>();
    }
    __syncthreads();
    const float4* xs = smem4 + (k & 1) * slot;
    const int pbase = x0 - 1 + k * C;
    for (int r = 0; r < C && pbase + r < x_end; ++r) {
      const int i = pbase + r;
      if (i >= 0 && i < nx) {         // the same for the whole block
        float v[24];
#pragma unroll
        for (int d = 0; d < 24; ++d) v[d] = 0.f;
        if (cell_ok) {
#pragma unroll
          for (int a = 0; a < 8; ++a) {
            const float4 n = xs[((r + corner_x(a)) * kNy + ty + corner_y(a)) *
                                    kNz + tz + corner_z(a)];
#pragma unroll
            for (int d = 0; d < 24; ++d) {
              v[d] += ke_v9[d * 24 + 3 * a + 0] * n.x;
              v[d] += ke_v9[d * 24 + 3 * a + 1] * n.y;
              v[d] += ke_v9[d * 24 + 3 * a + 2] * n.z;
            }
          }
          const float s = __ldg(ckp + (i * ny + cy) * nz + cz);
#pragma unroll
          for (int d = 0; d < 24; ++d) v[d] *= s;
        }
        // corner b of this cell is the node (i + dx, cy + dy, cz + dz)
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          __syncthreads();
          const int oy = ty - 1 + corner_y(b), oz = tz - 1 + corner_z(b);
          if (cell_ok && oy >= 0 && oy < kTy && oz >= 0 && oz < kTz) {
            float* o = acc + ((i + corner_x(b)) & 1) * 3 * kOut + oy * kTz + oz;
            o[0] += v[3 * b];
            o[kOut] += v[3 * b + 1];
            o[2 * kOut] += v[3 * b + 2];
          }
        }
      }
      __syncthreads();
      // node plane i has all its cells: write it, free its slot
      if (writer) {
        float* o = acc + (i & 1) * 3 * kOut + ty * kTz + tz;
        if (i >= x0) {
          float* yi = yp + (i * nyn + iy0 + ty) * nzn + iz0 + tz;
          yi[0] = o[0];
          yi[grid] = o[kOut];
          yi[2 * grid] = o[2 * kOut];
        }
        o[0] = o[kOut] = o[2 * kOut] = 0.f;
      }
      // the next plane's first placement starts with a barrier
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
  const size_t smem = smem_bytes(C);
  cudaError_t e = smv::allow_smem(matvec_v9_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  matvec_v9_kernel<<<static_cast<int>(blocks), kThreads, smem, stream>>>(
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
extern "C" int structured_matvec_v9_stage_f32(const void* ke, int device,
                                              void* stream) {
  return smv::stage(ke_v9, ke, device, stream);
}

extern "C" int structured_matvec_v9_f32(const void* x, const void* ck,
                                        void* y, int parts, int nx, int ny,
                                        int nz, int planes, int device,
                                        void* stream) {
  smv::DeviceScope scope(device);
  if (scope.error() != 0) return scope.error();
  return launch(x, ck, y, parts, nx, ny, nz, planes,
                static_cast<cudaStream_t>(stream));
}

SMV_ERROR_STRING(structured_matvec_v9)
