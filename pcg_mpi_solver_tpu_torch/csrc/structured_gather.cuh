// The node-owned gather of the structured-slab matvec, shared by
// structured_matvec_v5.cu (v5), structured_matvec_v3.cu (v3) and
// structured_matvec_v7.cu (v7), float:
// each thread owns two output nodes and gathers the eight corner products
// that land on them; no placement pass, no barrier between corners, no
// atomics.  A source chooses its constant bank of Ke (a Ke accessor,
// Ke::at(i) = element i of the row-major Ke) and launches the kernel
// through launch<Ke>.
//
// What bounds it on an H100 SXM (chip_smoke.py::matvec_bound_ms): about 28
// bytes per cell (x and y once per node, ck once per cell) against 576
// FMAs.  At 150^3 the bytes take 28.7 us at 3.35 TB/s, the FMAs 58.0 us on
// the CUDA cores (67 TFLOP/s) or 23.6 us as 3xTF32, so the bound is the
// bytes', 28.7 us.  This kernel does its FMAs on the CUDA cores (the 3xTF32
// product moves the flagship out of its iteration window, PERF.md), so
// they set its floor: 151^3 nodes x 576 FMAs, 59 us, 1.07x that with the
// idle lanes of its tiles at 150^3.
//
// Each node n takes, for each corner b, the three rows Ke[3b:3b+3] . u of
// the cell n - off_b (u = the cell's 24 corner values), scaled by that
// cell's ck (ck scales the product, not u: scaling u moved the flagship to
// 3135 iterations, PERF.md), and adds them to its three accumulators in a
// fixed b order.  Per node that is 8 x 3 x 24 = 576 FMAs, one cell's
// product: no cell is computed twice.
//
// The design:
//   * A block owns a kRows x 32 tile of output nodes in (y, z) and marches
//     an x segment of node planes.  Warp w owns rows 2w and 2w + 1, lane l
//     the z column l: a thread's two nodes are neighbours in y, so a warp's
//     shared-memory reads are 32 consecutive floats and a tile is 32 nodes
//     wide in z (151 = 5 x 32 - 9 at 150^3; 64-wide z pairs would waste 41).
//   * Node planes ((kRows + 2) x 34 nodes x 3 components) and ck planes
//     ((kRows + 1) x 33 cells) come into a ring of two groups by cp.async
//     (G planes a group, 2G + 2 slots: a group's G steps read G + 2 node
//     planes while the next group's G planes land), zero-filled off the
//     grid: an off-grid cell has ck = 0, so its products vanish and no
//     compute step checks a bound.  A group is a chunk of C planes (the
//     JAX package's PCG_TPU_PALLAS_PLANES) where its ring fits 227 KB at
//     the tile's rows, i.e. G = C up to C = 19 at 8 rows, 35 at 4 and 54
//     at 2; above that each chunk is staged in groups of G, the largest
//     whose ring fits (group_planes), the last one of a chunk shorter.
//     Chunks stay aligned at multiples of C from the segment's start.  The
//     arithmetic of a step does not depend on C or G: every C gives the
//     same bits.  A table built when the block starts holds each copy's
//     source offset within a plane and its destination, as in
//     structured_tiles.cuh.  Two barriers per group.
//   * A thread keeps its 3 x 4 x 3 node window (x, y, z; 3 components) and
//     2 x 3 x 2 ck window in registers and slides it along x: a step loads
//     one node plane of the window (36 values) and one ck plane (6) from
//     shared memory for 1152 FMAs.  Ke is read from shared memory as
//     float4 broadcasts, copied there from the library's constant bank
//     when the block starts, each value feeding the FMAs of both nodes of
//     the thread.  The step loop is not unrolled (unrolled by 3, the moves
//     would become renames, but the registers spill), and a compiler
//     barrier before each corner keeps Ke's loads inside the loop.
//   * The x segments fill the card's SMs; each starts from the node plane
//     and the cell plane before it (no carry).  The wrapper
//     (ops/structured_matvec.py::v5_geometry) chooses kRows (the tallest of
//     8, 4, 2 whose ring fits 227 KB at this C: 8 at C = 8 and 16), the
//     tiles and the segment length and passes them in; a C whose whole
//     ring does not fit even at 2 rows (C above 54) takes the 8-row tile
//     and is staged in groups of 19 (4.8x faster at 150^3 than 2 rows in
//     groups of 54, PERF.md).  At C = 8 two 128-thread blocks share an
//     SM (107.7 KB each).
//   * Each output node plane is written once, 32 consecutive z nodes a
//     warp row.  A fixed summation order: two launches give the same bits.
// Builds timed on the card (tools/v5_kernel_compare.py, PERF.md, Findings):
// 0.187 ms at 150^3 and C = 8.  Its instructions (about 1950 a step for
// 1152 FMAs) would take ~0.12 ms at one a cycle on every scheduler, so
// what is left is latency at eight warps an SM (181 registers a thread):
// Ke from the constant bank (3 % faster at C = 8, 9 % slower at 16), two
// output planes a step (2 % faster at 8, 35 % slower at 16) and a window
// rotated by renaming (no gain at 8, 38 % slower at 16) were built and not
// kept.

#pragma once

#include <cuda_runtime.h>

#include "structured_common.cuh"

namespace smv {
namespace gather {

constexpr int kLanesZ = 32;               // owned z nodes a tile row
constexpr int kNodesZ = kLanesZ + 2;      // staged nodes a row
constexpr int kCellsZ = kLanesZ + 1;      // staged cells a row

// The layout of a tile of kRows owned node rows.
template <int kRows>
struct Tile {
  static_assert(kRows % 2 == 0, "two rows a warp");
  static constexpr int kThreads = 16 * kRows;
  static constexpr int kComp = (kRows + 2) * kNodesZ;   // [c][yy][zz]
  static constexpr int kNodeSlot = 3 * kComp;
  static constexpr int kCkSlot = (kRows + 1) * kCellsZ; // [cy][cz]
  static constexpr int kSlot = kNodeSlot + kCkSlot;
  static constexpr int kCopies = kSlot;                 // one per value
};

// The shared memory a block can have on an H100 (227 KB).
constexpr size_t kBlockSmem = 232448;

// Values of one ring slot of a rows-high tile.
inline size_t slot_values(int rows) {
  return 3 * static_cast<size_t>(rows + 2) * kNodesZ +
         static_cast<size_t>(rows + 1) * kCellsZ;
}

// G, the planes of a staging group at chunk C: C where the ring of 2C + 2
// slots, Ke and the copy table fit kBlockSmem, else the largest G whose
// ring does (ops/structured_matvec.py::v5_group mirrors it).
inline int group_planes(int C, int rows) {
  const size_t slot = slot_values(rows);
  const size_t fixed = sizeof(float) * 576 + sizeof(int2) * slot;
  const long long fit =
      (static_cast<long long>((kBlockSmem - fixed) / (sizeof(float) * slot)) -
       2) / 2;
  return static_cast<int>(fit < C ? fit : C);
}

// Dynamic shared memory: the ring of 2G + 2 slots, Ke and the copy table
// (ops/structured_matvec.py::v5_smem_bytes mirrors it).
inline size_t smem_bytes(int C, int rows) {
  const size_t slot = slot_values(rows);
  const size_t G = static_cast<size_t>(group_planes(C, rows));
  return sizeof(float) * ((2 * G + 2) * slot + 576) + sizeof(int2) * slot;
}

template <class Ke, int kRows>
__global__ void __launch_bounds__(Tile<kRows>::kThreads, 1)
matvec_kernel(const float* __restrict__ x, const float* __restrict__ ck,
              float* __restrict__ y, int nx, int ny, int nz, int C, int G,
              int seg_len, int n_ty, int n_tz, int n_seg) {
  using T = Tile<kRows>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ring = 2 * G + 2;
  float* const ke_s = reinterpret_cast<float*>(smem_raw);     // [576]
  float* const slots = ke_s + 576;                            // [ring][kSlot]
  int2* const table =
      reinterpret_cast<int2*>(slots + static_cast<size_t>(ring) * T::kSlot);

  const int nxn = nx + 1, nyn = ny + 1, nzn = nz + 1;
  const int grid = nxn * nyn * nzn;
  int blk = blockIdx.x;
  const int tz = blk % n_tz;
  blk /= n_tz;
  const int ty = blk % n_ty;
  blk /= n_ty;
  const int seg = blk % n_seg;
  const int p = blk / n_seg;
  // local node (yy, zz) is global (iy0 - 1 + yy, iz0 - 1 + zz), local cell
  // (cy, cz) likewise; the block owns yy in [1, kRows], zz in [1, 32]
  const int iy0 = ty * kRows, iz0 = tz * kLanesZ;
  const int x0 = seg * seg_len, x_end = min(x0 + seg_len, nxn);
  const int n_steps = x_end - x0;          // output node planes
  const int n_node = n_steps + 2;          // node planes x0-1 .. x_end
  const float* const xp = x + static_cast<size_t>(p) * 3 * grid;
  const float* const ckp = ck + static_cast<size_t>(p) * nx * ny * nz;
  float* const yp = y + static_cast<size_t>(p) * 3 * grid;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  // copy e of a plane: source offset within the plane (-1 off the grid in
  // y or z) and destination within a slot; node values first, then ck
  for (int e = tid; e < T::kCopies; e += T::kThreads) {
    int src, dst = e;
    if (e < T::kNodeSlot) {
      const int r = e / kNodesZ, zz = e % kNodesZ;
      const int c = r / (kRows + 2), yy = r % (kRows + 2);
      const int gy = iy0 - 1 + yy, gz = iz0 - 1 + zz;
      src = gy >= 0 && gy < nyn && gz >= 0 && gz < nzn
                ? c * grid + gy * nzn + gz : -1;
    } else {
      const int cy = (e - T::kNodeSlot) / kCellsZ;
      const int cz = (e - T::kNodeSlot) % kCellsZ;
      const int gy = iy0 - 1 + cy, gz = iz0 - 1 + cz;
      src = gy >= 0 && gy < ny && gz >= 0 && gz < nz ? gy * nz + gz : -1;
    }
    table[e] = make_int2(src, dst);
  }
  for (int e = tid; e < 576; e += T::kThreads) ke_s[e] = Ke::at(e);
  __syncthreads();

  // slots [j0, j1) of the segment: node plane and ck plane x0-1+j into
  // ring slot j % ring (no ck plane past the last cell plane); one commit
  // group, empty past the segment
  auto issue = [&](int j0, int j1) {
    for (int j = j0; j < min(j1, n_node); ++j) {
      const int gp = x0 - 1 + j;
      const bool node_ok = gp >= 0 && gp < nxn;
      const bool ck_ok = gp >= 0 && gp < nx;
      const float* const xq = xp + (node_ok ? gp * nyn * nzn : 0);
      const float* const cq = ckp + (ck_ok ? gp * ny * nz : 0);
      float* const s = slots + static_cast<size_t>(j % ring) * T::kSlot;
      const int n_copies = j <= n_steps ? T::kCopies : T::kNodeSlot;
      for (int e = tid; e < n_copies; e += T::kThreads) {
        const int2 d = table[e];
        if (e < T::kNodeSlot) {
          const bool ok = node_ok && d.x >= 0;
          copy4(s + d.y, ok ? xq + d.x : xp, ok);
        } else {
          const bool ok = ck_ok && d.x >= 0;
          copy4(s + d.y, ok ? cq + d.x : ckp, ok);
        }
      }
    }
    commit_copies();
  };

  // the thread's windows: w[px][ry][rz][c] = node (i - 1 + px, gy - 1 + ry,
  // gz - 1 + rz) component c, gy = iy0 + 2 warp the first owned row, gz =
  // iz0 + lane; s[px][ry][rz] = ck of cell (i - 1 + px, gy - 1 + ry,
  // gz - 1 + rz); i is the output node plane
  float w[3][4][3][3];
  float s[2][3][2];
  const int node0 = 2 * warp * kNodesZ + lane;   // slot offset of (ry, rz) 0
  const int cell0 = T::kNodeSlot + 2 * warp * kCellsZ + lane;
  auto load_nodes = [&](int px, int j) {
    const float* const n = slots + static_cast<size_t>(j % ring) * T::kSlot +
                           node0;
#pragma unroll
    for (int ry = 0; ry < 4; ++ry)
#pragma unroll
      for (int rz = 0; rz < 3; ++rz)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          w[px][ry][rz][c] = n[c * T::kComp + ry * kNodesZ + rz];
  };
  auto load_cks = [&](int px, int j) {
    const float* const q = slots + static_cast<size_t>(j % ring) * T::kSlot +
                           cell0;
#pragma unroll
    for (int ry = 0; ry < 3; ++ry)
#pragma unroll
      for (int rz = 0; rz < 2; ++rz) s[px][ry][rz] = q[ry * kCellsZ + rz];
  };
  const float4* const ke4 = reinterpret_cast<const float4*>(ke_s);
  const int gy = iy0 + 2 * warp, gz = iz0 + lane;

  // group q ends at step group_end(q): groups of G steps from each chunk
  // start (a multiple of C), the last one of a chunk shorter; with G = C a
  // group is a chunk
  const int per_chunk = (C + G - 1) / G;
  auto group_end = [&](int q) {
    const int g = q % per_chunk;
    return min(q / per_chunk * C + min(g * G + G, C), n_steps);
  };
  issue(0, group_end(0) + 2);
  for (int q = 0, k = 0; k < n_steps; ++q) {
    // the next group's slots, into those of group q - 1's first steps,
    // read before its last barrier
    const int k_end = group_end(q);
    issue(k_end + 2, group_end(q + 1) + 2);
    wait_copies<1>();
    __syncthreads();
    if (q == 0) {
      load_nodes(1, 0);
      load_nodes(2, 1);
      load_cks(1, 0);
    }
    for (; k < k_end; ++k) {
      // slide: node planes k, k+1, k+2 and cell planes k, k+1 of the slots
#pragma unroll
      for (int ry = 0; ry < 4; ++ry)
#pragma unroll
        for (int rz = 0; rz < 3; ++rz)
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            w[0][ry][rz][c] = w[1][ry][rz][c];
            w[1][ry][rz][c] = w[2][ry][rz][c];
          }
#pragma unroll
      for (int ry = 0; ry < 3; ++ry)
#pragma unroll
        for (int rz = 0; rz < 2; ++rz) s[0][ry][rz] = s[1][ry][rz];
      load_nodes(2, k + 2);
      load_cks(1, k + 1);

      float acc[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        // node (row j) is corner b of cell (i - dxb, gy + j - dyb, gz - dzb)
        const int dxb = corner_x(b), dyb = corner_y(b), dzb = corner_z(b);
        // Ke is invariant across the steps: without this compiler barrier
        // its 576 values are hoisted out of the x march and spilled
        asm volatile("" ::: "memory");
        float t[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
#pragma unroll
        for (int e4 = 0; e4 < 6; ++e4) {
#pragma unroll
          for (int r = 0; r < 3; ++r) {
            const float4 kv = ke4[(3 * b + r) * 6 + e4];
            const float kq[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
            for (int qq = 0; qq < 4; ++qq) {
              const int e = 4 * e4 + qq, a = e / 3, c = e % 3;
              const int px = 1 - dxb + corner_x(a);
              const int rz = 1 - dzb + corner_z(a);
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const int ry = j + 1 - dyb + corner_y(a);
                t[j][r] = fmaf(kq[qq], w[px][ry][rz][c], t[j][r]);
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float sc = s[1 - dxb][j + 1 - dyb][1 - dzb];
#pragma unroll
          for (int r = 0; r < 3; ++r) acc[j][r] = fmaf(sc, t[j][r], acc[j][r]);
        }
      }
      const int i = x0 + k;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (gy + j < nyn && gz < nzn) {
          float* const out = yp + (static_cast<size_t>(i) * nyn + gy + j) *
                                      nzn + gz;
#pragma unroll
          for (int r = 0; r < 3; ++r) out[static_cast<size_t>(r) * grid] =
              acc[j][r];
        }
      }
    }
    __syncthreads();
  }
}

template <class Ke, int kRows>
int launch_rows(const float* x, const float* ck, float* y, int parts, int nx,
                int ny, int nz, int C, int seg_len, int n_ty, int n_tz,
                int n_seg, cudaStream_t stream) {
  const long long blocks =
      static_cast<long long>(parts) * n_seg * n_ty * n_tz;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(C, kRows);
  cudaError_t e = allow_smem(matvec_kernel<Ke, kRows>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  matvec_kernel<Ke, kRows><<<static_cast<int>(blocks),
                             Tile<kRows>::kThreads, smem, stream>>>(
      x, ck, y, nx, ny, nz, C, group_planes(C, kRows), seg_len, n_ty, n_tz,
      n_seg);
  return static_cast<int>(cudaGetLastError());
}


// Launches the kernel with Ke read from Ke::at on `device`: x
// (P,3,nx+1,ny+1,nz+1) and ck (P,nx,ny,nz) contiguous float device
// buffers, y allocated by the caller with x's shape; `planes` is C and the
// rest the launch geometry of ops/structured_matvec.py::v5_geometry: tiles
// of `rows` (8, 4 or 2) x 32 nodes, n_ty x n_tz of them, n_seg x segments
// of seg_len node planes.  Returns the CUDA error code of the launch (0 =
// launched).
template <class Ke>
int launch(const void* x, const void* ck, void* y, int parts, int nx,
           int ny, int nz, int planes, int rows, int seg_len, int n_ty,
           int n_tz, int n_seg, int device, void* stream) {
  DeviceScope scope(device);
  if (scope.error() != 0) return scope.error();
  if (planes < 1 || seg_len < 1 || n_ty < 1 || n_tz < 1 || n_seg < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* xf = static_cast<const float*>(x);
  const auto* cf = static_cast<const float*>(ck);
  auto* yf = static_cast<float*>(y);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 8:
      return launch_rows<Ke, 8>(xf, cf, yf, parts, nx, ny, nz, planes,
                                seg_len, n_ty, n_tz, n_seg, s);
    case 4:
      return launch_rows<Ke, 4>(xf, cf, yf, parts, nx, ny, nz, planes,
                                seg_len, n_ty, n_tz, n_seg, s);
    case 2:
      return launch_rows<Ke, 2>(xf, cf, yf, parts, nx, ny, nz, planes,
                                seg_len, n_ty, n_tz, n_seg, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace gather
}  // namespace smv
