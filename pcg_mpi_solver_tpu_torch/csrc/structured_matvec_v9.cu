// Structured-slab block-stencil matvec for Hopper (sm_90a), float: warp
// strips marching x, several cells a thread sharing each Ke load, placement
// in registers and warp shuffles.
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
// What bounds it on an H100 SXM (chip_smoke.py::matvec_bound_ms): at the
// flagship 150^3 slab the bytes (x and y once per node, ck once per cell:
// 96.13 MB) take 28.7 us at 3.35 TB/s, the bound of any float-accurate
// kernel.  This kernel does its 576 FMAs a cell on the CUDA cores, and
// those take 58.0 us at 67 TFLOP/s at 1.0x the cells, so they set its
// floor; every instruction that is not an FFMA takes an issue slot from
// them.  The design keeps the non-FFMA instructions few.
//
// What the TPU kernel computes, kept here with its order of arithmetic: per
// cell v = sum_a KeT[a] . x_a over the eight input corners a (eight (24,3)
// dots; the gathered 24-vector is never built), v scaled by ck once after
// the product, output corner b's three values v[3b .. 3b+2] (the TPU's
// one-hot sel dot, a register select here), dx = 1 values carried to the
// next plane.  Nodes are staged in shared memory as float4 (x, y, z, 0),
// the TPU's 4-row plane-major slab, so a corner read is one 16-byte shared
// load; nothing is padded or transposed on the host.  Each cell's v and
// each node's sum are formed in the same order as in the earlier kernel of
// this file, one thread a cell with placement through shared memory
// (Ke[d][e] . x_e summed e = 0..23 by FMAs, then ck; a node adds its
// dx = 1 corners b = 1, 2, 5, 6 of the plane before, then its dx = 0
// corners b = 0, 3, 4, 7), so the two give the same values.
//
// The design:
//   * A block of kWarps warps owns a (kWarps (kRows - 1)) x 31 tile of
//     output nodes in (y, z) and marches an x segment of node planes.
//     Warp w owns a strip of kRows cell rows x 32 cell columns, lane l the
//     cell column iz0 - 1 + l, and computes every cell of the strip in
//     each cell plane, kCells rows a step: each Ke value (a float4
//     broadcast from shared memory over four output dofs, KeT[e][d..d+3])
//     feeds 4 kCells FFMAs.  A step runs the product in two passes over
//     the inputs, output dofs 0-11 (corners 0-3) then 12-23 (corners
//     4-7): half the accumulators, so no registers spill, for twice the
//     node loads (one 16-byte load a corner and cell a pass).  A compiler
//     barrier before each input corner keeps Ke's loads from being hoisted
//     out of the x march and spilled (v5's trap).
//   * Placement never leaves the registers.  A lane's node column is its
//     cell's dz = 0 column: its cell's dz = 1 corners (12 values) go to
//     lane + 1 by __shfl_up_sync; the dy = 1 corners (own and shuffled)
//     stay in the lane for the next cell row; the dx = 1 sums of each
//     node row of the strip are carried in registers to the next cell
//     plane (kRows x 3 values, rotated by kCells rows a step so the row
//     loop need not be unrolled).  A lane writes each finished node
//     straight to y, 31 consecutive z values a warp row.  No shared-memory
//     accumulators, no placement barrier, no atomics, a fixed summation
//     order: two launches give the same bits.
//   * Recompute instead of exchange: lane 0 of a strip (its cell column
//     serves lane 1's node only) and the strip's first cell row (it serves
//     the second node row only) are computed by the neighbouring strip
//     too, kRows / (kRows - 1) x 32 / 31 = 1.24x the cells at kRows = 6;
//     each x segment also recomputes the cell plane before it, (seg_len +
//     1) / seg_len more (13/12 at 150^3, where ops/structured_matvec.py's
//     v9_geometry makes 12-plane segments to fill the SMs).  With the
//     tiles' fill, the kernel executes 1.43x the cells' FMAs at 150^3
//     (tools/v9_kernel_compare.py::fmas_v9).  A strip with no node row on
//     the grid and a cell plane off the grid skip the product.
//   * The staging ring is the only thing the block shares: kStages slots
//     of (kWarps (kRows - 1) + 2) x 33 nodes of the tile and its halo, by
//     cp.async (three 4-byte copies a node, zero-filled off the grid; the
//     4th lane zeroed once).  One block-wide barrier a cell plane: after
//     it, node plane k + 2 is issued into the slot of plane k - 1, which
//     every warp has finished with, and lands while plane k is computed.
//     ck is read with __ldg, kCells values a lane per step, before the
//     product.
//   * 256 threads, two blocks an SM (16 warps), kRows = 6 and kCells = 2:
//     24 accumulators, 12 partial node sums, 18 carried sums and 12 held
//     corner values a thread fit the 128 registers two blocks allow with
//     no spill.  68.8 KB of shared memory a block.
// Measured on the card (tools/v9_kernel_compare.py; PERF.md, Findings):
// 0.236 ms at 150^3, the earlier kernel 0.391, v6 float 0.186.  Its loop
// issues 1.44 instructions per FFMA against v6's 1.73, yet it is slower,
// so issue does not bound it.  The sweep (-DV9_ROWS / -DV9_CELLS): 8- and
// 4-row strips 5 % and 14 % slower, 1 and 3 cells a step 31 % and 7 %
// slower (3 spills).  Built, measured and not kept (source in git
// history, PERF.md names the commits): one pass with 48 accumulators
// (spills 24 B, 4 % slower), three or four blocks an SM under fewer
// registers (spill, 19-72 % slower), Ke from the constant bank (a ULDC
// per two FFMAs, 65 % slower), ck read after the product (2 % slower).
// The compiler barrier once a pass or every two corners instead of every
// corner changes neither the SASS counts nor the time.

#include <cuda_runtime.h>

#include "structured_common.cuh"

#ifndef V9_ROWS
#define V9_ROWS 6          // cell rows a warp strip
#endif
#ifndef V9_CELLS
#define V9_CELLS 2         // cell rows a thread computes at once
#endif

namespace {

using smv::corner_x;
using smv::corner_y;
using smv::corner_z;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 2;                  // blocks an SM
constexpr int kRows = V9_ROWS;
constexpr int kCells = V9_CELLS;
static_assert(kRows >= 2 && kRows % kCells == 0,
              "a strip is whole steps of kCells rows");
constexpr int kPasses = 2;                     // passes over the inputs
constexpr int kDofs = 24 / kPasses;            // output dofs a pass
constexpr int kTy = kWarps * (kRows - 1);      // owned node rows a block
constexpr int kTz = 31;                        // owned node columns
constexpr int kNy = kTy + 2, kNz = kTz + 2;    // staged node rows, columns
constexpr int kStages = 3;                     // ring slots of node planes
constexpr int kSlot = kNy * kNz;               // float4 a slot
// dynamic shared memory: the ring and KeT (ops/structured_matvec.py::
// v9_smem_bytes mirrors it)
constexpr size_t kSmemBytes =
    sizeof(float4) * kStages * static_cast<size_t>(kSlot) +
    sizeof(float) * 24 * 24;
static_assert(kMinBlocks * (kSmemBytes + 1024) <= 233472,
              "two blocks an SM: 228 KB less 1 KB reserved a block");

__constant__ float ke_v9[24 * 24];

__global__ void __launch_bounds__(kThreads, kMinBlocks)
matvec_v9_kernel(const float* __restrict__ x, const float* __restrict__ ck,
                 float* __restrict__ y, int nx, int ny, int nz, int seg_len,
                 int n_ty, int n_tz, int n_seg) {
  extern __shared__ __align__(16) float4 smem4[];
  float4* const nodes = smem4;                 // [kStages][kNy][kNz]
  float* const ke_s = reinterpret_cast<float*>(smem4 + kStages * kSlot);
  const float4* const ke4 = reinterpret_cast<const float4*>(ke_s);

  const int nxn = nx + 1, nyn = ny + 1, nzn = nz + 1;
  const int grid = nxn * nyn * nzn;
  int blk = blockIdx.x;
  const int tz = blk % n_tz;
  blk /= n_tz;
  const int ty = blk % n_ty;
  blk /= n_ty;
  const int seg = blk % n_seg;
  const int p = blk / n_seg;
  // staged node (yy, zz) is global (iy0 - 1 + yy, iz0 - 1 + zz); the block
  // owns yy in [1, kTy], zz in [1, 31]
  const int iy0 = ty * kTy, iz0 = tz * kTz;
  const int x0 = seg * seg_len, x_end = min(x0 + seg_len, nxn);
  const int n_steps = x_end - x0 + 1;    // cell planes x0-1 .. x_end-1
  const int n_node = n_steps + 1;        // node planes x0-1 .. x_end
  const float* const xp = x + static_cast<size_t>(p) * 3 * grid;
  const float* const ckp = ck + static_cast<size_t>(p) * nx * ny * nz;
  float* const yp = y + static_cast<size_t>(p) * 3 * grid;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // the 4th lanes, and KeT: ke_s[24 e + d] = Ke[d][e]
  for (int e = tid; e < kStages * kSlot; e += kThreads) nodes[e].w = 0.f;
  for (int e = tid; e < 24 * 24; e += kThreads) {
    ke_s[e] = ke_v9[(e % 24) * 24 + e / 24];
  }

  // node plane x0-1+j into slot j % kStages, a warp a (component, row),
  // the lanes along z; one commit group
  auto issue = [&](int j) {
    const int gp = x0 - 1 + j;
    const bool plane_ok = gp >= 0 && gp < nxn;
    float* const s = reinterpret_cast<float*>(nodes + (j % kStages) * kSlot);
    for (int row = warp; row < 3 * kNy; row += kWarps) {
      const int c = row / kNy, yy = row - c * kNy;
      const int gy = iy0 - 1 + yy;
      const bool row_ok = plane_ok && gy >= 0 && gy < nyn;
      const float* const src =
          xp + (row_ok ? c * grid + (gp * nyn + gy) * nzn : 0);
      for (int zz = lane; zz < kNz; zz += 32) {
        const int gz = iz0 - 1 + zz;
        const bool ok = row_ok && gz >= 0 && gz < nzn;
        smv::copy4(s + 4 * (yy * kNz + zz) + c, ok ? src + gz : xp, ok);
      }
    }
    smv::commit_copies();
  };

  // strip row r is staged node row wy + r, cell row cy0 + r and node row
  // cy0 + r (global); the warp owns node rows r = 1 .. kRows-1, lanes
  // 1 .. 31 (the lane's node column is its cell column gz)
  const int wy = warp * (kRows - 1);
  const int cy0 = iy0 - 1 + wy;
  const int gz = iz0 - 1 + lane;
  const bool strip_live = cy0 + 1 < nyn;
  const bool cell_z = gz >= 0 && gz < nz;
  const bool node_z = lane >= 1 && gz < nzn;

  // carry[q]: the dx = 1 sums for the next node plane, strip row q (+ r0
  // of the step, rotated)
  float carry[kRows][3];
#pragma unroll
  for (int q = 0; q < kRows; ++q)
#pragma unroll
    for (int c = 0; c < 3; ++c) carry[q][c] = 0.f;

  issue(0);
  issue(1);
  for (int k = 0; k < n_steps; ++k) {
    smv::wait_copies<0>();                 // node planes k, k+1
    __syncthreads();
    if (k + 2 < n_node) issue(k + 2);      // into plane k-1's slot
    if (!strip_live) continue;             // the same for the whole warp
    const int i = x0 - 1 + k;              // cell plane
    const bool plane_live = i >= 0 && i < nx;
    const float4* const n0 = nodes + (k % kStages) * kSlot + wy * kNz + lane;
    const float4* const n1 =
        nodes + ((k + 1) % kStages) * kSlot + wy * kNz + lane;
    // corners 2, 3 (own) and 6, 7 (lane - 1's) of the cell row before
    float prev[4][3];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int c = 0; c < 3; ++c) prev[q][c] = 0.f;

#pragma unroll 1
    for (int r0 = 0; r0 < kRows; r0 += kCells) {
      // node row r0 + j gets, in this order, the carried c1 + c2 + c5 + c6
      // of the plane before, then c0 (own cell), c3 (own, row r-1), c4
      // (lane-1), c7 (lane-1, row r-1); part 1 adds what corners 0-3 give
      // (pass 0), part 2 what corners 4-7 give (the last pass)
      float next[kCells][3], out[kCells][3];
      float s[kCells];                     // ck of the rows, 0 off the grid
#pragma unroll
      for (int pass = 0; pass < kPasses; ++pass) {
        // v[j][d - pass kDofs]: output dof d of cell row r0 + j
        float v[kCells][kDofs];
#pragma unroll
        for (int j = 0; j < kCells; ++j)
#pragma unroll
          for (int d = 0; d < kDofs; ++d) v[j][d] = 0.f;
        if (plane_live) {                  // the same for the whole block
          if (pass == 0) {
#pragma unroll
            for (int j = 0; j < kCells; ++j) {
              const int cy = cy0 + r0 + j;
              s[j] = cell_z && cy >= 0 && cy < ny
                         ? __ldg(ckp + (i * ny + cy) * nz + gz) : 0.f;
            }
          }
#pragma unroll
          for (int a = 0; a < 8; ++a) {
            asm volatile("" ::: "memory");
            float4 n[kCells];
#pragma unroll
            for (int j = 0; j < kCells; ++j) {
              n[j] = (corner_x(a) ? n1 : n0)[(r0 + j + corner_y(a)) * kNz +
                                             corner_z(a)];
            }
#pragma unroll
            for (int c = 0; c < 3; ++c) {
#pragma unroll
              for (int d4 = 0; d4 < kDofs / 4; ++d4) {
                const float4 kv =
                    ke4[(3 * a + c) * 6 + pass * kDofs / 4 + d4];
#pragma unroll
                for (int j = 0; j < kCells; ++j) {
                  const float u = c == 0 ? n[j].x : c == 1 ? n[j].y : n[j].z;
                  v[j][4 * d4] = fmaf(kv.x, u, v[j][4 * d4]);
                  v[j][4 * d4 + 1] = fmaf(kv.y, u, v[j][4 * d4 + 1]);
                  v[j][4 * d4 + 2] = fmaf(kv.z, u, v[j][4 * d4 + 2]);
                  v[j][4 * d4 + 3] = fmaf(kv.w, u, v[j][4 * d4 + 3]);
                }
              }
            }
          }
#pragma unroll
          for (int j = 0; j < kCells; ++j)
#pragma unroll
            for (int d = 0; d < kDofs; ++d) v[j][d] *= s[j];
        }
#pragma unroll
        for (int j = 0; j < kCells; ++j) {
          // value of output dof d of cell row r0 + j (d in this pass)
          auto at = [&](int d) { return v[j][d - pass * kDofs]; };
          if (pass == 0) {                 // part 1: corners 0-3
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              next[j][c] = at(3 + c) + prev[0][c];
              out[j][c] = (carry[j][c] + at(c)) + prev[1][c];
              prev[0][c] = at(6 + c);
              prev[1][c] = at(9 + c);
            }
          }
          if (pass == kPasses - 1) {       // part 2: corners 4-7
            float sh[4][3];                // corners 4..7 of lane - 1's cell
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
              for (int c = 0; c < 3; ++c)
                sh[q][c] = __shfl_up_sync(0xffffffffu, at(3 * (4 + q) + c),
                                          1);
            const int r = r0 + j;
            const int gy = cy0 + r;
            const bool write = k > 0 && r > 0 && node_z && gy < nyn;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              next[j][c] = (next[j][c] + sh[1][c]) + prev[2][c];
              const float o = (out[j][c] + sh[0][c]) + prev[3][c];
              if (write) {
                yp[c * grid + (i * nyn + gy) * nzn + gz] = o;
              }
              prev[2][c] = sh[2][c];
              prev[3][c] = sh[3][c];
            }
          }
        }
      }
      // rotate: the rows of the next step to the front, this step's
      // carries (for the next plane) to the back
#pragma unroll
      for (int q = 0; q < kRows - kCells; ++q)
#pragma unroll
        for (int c = 0; c < 3; ++c) carry[q][c] = carry[q + kCells][c];
#pragma unroll
      for (int j = 0; j < kCells; ++j)
#pragma unroll
        for (int c = 0; c < 3; ++c) carry[kRows - kCells + j][c] = next[j][c];
    }
  }
}

// Launches the kernel on the current device with the grid of
// ops/structured_matvec.py::v9_geometry: n_ty x n_tz tiles of kTy x 31
// nodes, n_seg x segments of seg_len node planes; a grid that does not
// cover the slab with this build's tile (a wrapper out of step with the
// source) is refused.
int launch(const float* x, const float* ck, float* y, int parts, int nx,
           int ny, int nz, int seg_len, int n_ty, int n_tz, int n_seg,
           cudaStream_t stream) {
  const long long blocks =
      static_cast<long long>(parts) * n_seg * n_ty * n_tz;
  if (seg_len < 1 || n_ty != (ny + kTy) / kTy || n_tz != (nz + kTz) / kTz ||
      n_seg != (nx + seg_len) / seg_len || blocks < 1 ||
      blocks >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = smv::allow_smem(matvec_v9_kernel, kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  matvec_v9_kernel<<<static_cast<int>(blocks), kThreads, kSmemBytes,
                     stream>>>(x, ck, y, nx, ny, nz, seg_len, n_ty, n_tz,
                               n_seg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points.  stage copies ke (24,24), a contiguous float device
// buffer, into this library's constant bank on `device`.  The matvec takes
// x (P,3,nx+1,ny+1,nz+1) and ck (P,nx,ny,nz), contiguous float device
// buffers, and writes y, allocated by the caller with x's shape, using the
// Ke staged last; the launch geometry (seg_len, n_ty, n_tz, n_seg) comes
// from ops/structured_matvec.py::v9_geometry.  The wrapper checks shapes,
// dtype and contiguity and keeps every index below 2^31.  Each returns the
// CUDA error code of its copy or launch (0 = done / launched).
extern "C" int structured_matvec_v9_stage_f32(const void* ke, int device,
                                              void* stream) {
  return smv::stage(ke_v9, ke, device, stream);
}

extern "C" int structured_matvec_v9_f32(const void* x, const void* ck,
                                        void* y, int parts, int nx, int ny,
                                        int nz, int seg_len, int n_ty,
                                        int n_tz, int n_seg, int device,
                                        void* stream) {
  smv::DeviceScope scope(device);
  if (scope.error() != 0) return scope.error();
  return launch(static_cast<const float*>(x), static_cast<const float*>(ck),
                static_cast<float*>(y), parts, nx, ny, nz, seg_len, n_ty,
                n_tz, n_seg, static_cast<cudaStream_t>(stream));
}

// The dynamic shared memory of a block, for reports and the wrapper's
// mirror check (ops/structured_matvec.py::v9_smem_bytes).
extern "C" long long structured_matvec_v9_smem_bytes() {
  return static_cast<long long>(kSmemBytes);
}

SMV_ERROR_STRING(structured_matvec_v9)
