// Structured-slab block-stencil matvec for Hopper (sm_90a), float and double:
// cell-centred tiles staged in shared memory by cp.async; the 24 x 24 cell
// product as unrolled FFMAs (float) and on the FP64 tensor cores (double).
//
// Replaces pcg_mpi_solver_tpu/ops/pallas_matvec.py::structured_matvec_pallas_v6
// (kernel _matvec_kernel_v6, the TPU kernel the JAX package's structured
// backend launches for every f32 matvec) and its per-part dispatch loop
// batched_structured_matvec: one launch here covers the whole leading part
// axis.  The double instantiation also takes the f64 matvecs the JAX
// package left to XLA (Dirichlet lifting, the refinement refreshes of
// pcg_mixed, every matvec of a direct f64 solve), whichever variant
// PCG_TPU_PALLAS_V selects for float.
//
// Function (StructuredOps.matvec_local, one slab per part p):
//   y[p] = sum_b shift_b( sum_a Ke[3b:3b+3, 3a:3a+3] . (ck[p] * x[p]_a) )
// x, y: (P, 3, nx+1, ny+1, nz+1) component-major node grids; ck: (P, nx, ny,
// nz) per-cell stiffness scales; Ke: (24, 24) unit element stiffness in
// element-dof order 3*corner + comp, corners in VTK hexahedron order.
//
// What bounds it on an H100 SXM (chip_smoke.py::matvec_bound_ms): per cell
// 24*24 = 576 FMAs and about 28 bytes in float (x and y once per node, ck
// once per cell).  At the flagship 150^3 slab that is 3.888 GFLOP against
// 96.13 MB.  Float: the bytes take 28.7 us at 3.35 TB/s; a float-accurate
// product takes 58.0 us on the CUDA cores (67 TFLOP/s) or 23.6 us as 3xTF32
// on the tensor cores (3 x 3.888 GFLOP at 495 TFLOP/s), so the bytes bound
// it.  Double: 58.0 us on the FP64 tensor cores (67 TFLOP/s) against 57.4 us
// of bytes, so the operations bound it.
//
// The design takes what the TPU kernel keeps out of HBM, not its blocks:
//   * A block owns a (kCy-1) x 31 tile of output nodes in (y, z) and marches
//     an x segment of node planes.  Per cell plane it computes the kCy x 32
//     cells around its nodes: float 32 x 32 cells, 512 threads, one block
//     an SM (1.14x the cells of the nodes at 150^3); double 8 x 32, 256
//     threads, two blocks an SM (1.25x).  The dx = 1 half of each cell
//     plane's product is the carry into the next node plane, kept in
//     registers (the TPU kernel's acc scratch).  The x segments fill the
//     card (the wrapper, ops/structured_matvec.py::v6_geometry, chooses
//     their length and passes the tile and segment counts to the entry
//     point); each first recomputes the cell plane before it for its
//     carry.  No atomics and a fixed summation order: two launches give
//     the same bits.
//   * Node planes (3 components, (kCy+1) x 33 nodes) and ck planes (kCy x 32
//     cells) go into a ring of kStages slots in shared memory by cp.async,
//     kStages - 2 planes ahead of the one computed (float 3, double 4:
//     the depths chosen by timing at 150^3, PERF.md, Findings).  A table
//     built when the block starts holds each copy's source offset within a
//     plane and its destination, so a copy costs a table load, an add and
//     the cp.async.
//     Off-grid nodes and cells are zero-filled: a cell off the grid has ck
//     = 0, so its product vanishes and no compute step checks a bound.  The
//     first kernel made 81 bounds-checked x loads and 8 ck loads per node
//     (each x value loaded by 27 threads); here every value crosses from
//     global memory once per block.  TMA cannot stage these planes: a
//     tensor map needs global strides in multiples of 16 bytes, and a z row
//     is (nz+1) values.  Nothing is padded on the host (the TPU v6 pads x
//     every matvec).
//   * The cell product, F = U . Ke^T with U the cells x 24 gathered corner
//     values, is a compile-time choice of CellProduct<T>:
//     - double: DMMA (mma.sync m16n8k8 .f64), exact IEEE FMAs on the
//       tensor cores, 16 cells along z an M tile.  The K order is permuted
//       so that one k step is one component and a lane's two k columns are
//       the dz = 0, 1 corners of one (dx, dy): its A fragment is four
//       shared-memory loads at offsets fixed per lane.  Ke's B fragments
//       live in registers for the block's life, read once from the
//       constant bank.
//     - float: unrolled FFMAs, two cells a thread.  3xTF32 on the tensor
//       cores (hi = tf32(v), lo = tf32(v - hi), lo.hi + hi.lo then hi.hi in
//       a float accumulator; 1xTF32's 10 mantissa bits miss the 2e-5 x
//       max|y| tolerance) was built first and measured on the card:
//       within the tolerance and 4 % faster, but its larger round-off
//       moved the flagship solve's second
//       stagnation exit from 1568 to 1349 iterations, 3112 in all, 6.7 %
//       under the JAX package's 3334 (PERF.md, Findings).
//     The first kernel's ceiling was the CUDA cores' 58 us; its index and
//     bounds arithmetic also took the FMAs' issue slots.  Here a cell's
//     FMAs come with 24 shared-memory loads and no index arithmetic.
//   * ck scales each cell's product once, as the first kernel did: scaling
//     the inputs instead moves the flagship's stagnation exit by ~200
//     iterations (PERF.md, Findings).
//   * Placement: ck * F goes to shared memory; each owned node sums its 4
//     dx = 0 corner entries into the carry of its plane in a fixed order
//     and starts the next plane's carry from its 4 dx = 1 entries.  Each
//     output plane is written once, 31 consecutive z nodes per warp.
//   * Shared-memory strides are padded so the double's fragment loads and
//     stores hit 16 distinct 8-byte banks per half warp (its ring depth is
//     even); the float's loads and stores are 32 consecutive values.
// Shared memory: kStages x (node slot + ck plane) + 24 rows of F + Ke
// (float) + the copy table: 195,416 bytes (float) and 98,392 (double),
// fixed at compile time and held below a block's 227 KB there.  This file
// owns the layout; the wrapper knows only the tile shape and the blocks
// an SM holds.
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

constexpr int kCellsZ = 32;               // cells a tile row
constexpr int kNodesZ = kCellsZ + 1;      // staged nodes a row

__constant__ float ke_f32[24 * 24];
__constant__ double ke_f64[24 * 24];

// smallest m >= n with m % mod == rem
__host__ __device__ constexpr int pad_to(int n, int rem, int mod) {
  return n + ((rem - n % mod) % mod + mod) % mod;
}

// Ring slots per dtype.  tools/v6_kernel_compare.py --sweep builds the
// kernel at other depths to time them against these.
#ifndef V6_STAGES_F32
#define V6_STAGES_F32 3
#endif
#ifndef V6_STAGES_F64
#define V6_STAGES_F64 4
#endif

// The tile and shared-memory layout of one dtype (the tile shape and
// blocks an SM are also ops/structured_matvec.py's V6_CELLS_Y/Z and
// V6_BLOCKS_PER_SM).  kWords values of T fill one pass of the 32 four-byte
// banks; the pads serve the double's fragments.
template <typename T>
struct Layout {
  // float: 512 threads, one block an SM, 32 x 32 cells (1.14x the cells
  // of the nodes at 150^3); double: 256 threads, two blocks an SM, 8 x 32
  static constexpr bool kFloat = sizeof(T) == 4;
  static constexpr int kThreads = kFloat ? 512 : 256;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kMinBlocks = kFloat ? 1 : 2;       // an SM
  static constexpr int kCy = kFloat ? 32 : 8;             // cells a tile col
  static constexpr int kWords = 128 / sizeof(T);
  // node slot [c][yy][zz]: rows kWords/4 apart mod kWords, the dx = 1
  // slot kWords/2 from the dx = 0 one
  static constexpr int kRow = pad_to(kNodesZ, kWords / 4, kWords);
  static constexpr int kComp = (kCy + 1) * kRow;
  static constexpr int kSlot = pad_to(3 * kComp, kWords / 2, kWords);
  static constexpr int kCk = kCy * kCellsZ;        // ck plane [cy][cz]
  // F [dof][cell]: dofs 2t and 2t' land kWords/4 apart
  static constexpr int kF = pad_to(kCk, kWords / 8, kWords / 2);
  static constexpr int kRowsPerWarp = kCy / kWarps;        // owned rows
  static constexpr int kKe = kFloat ? 24 * 24 : 0;        // Ke, float
  // the copies of one plane: node values, then ck values
  static constexpr int kNodeCopies = 3 * (kCy + 1) * kNodesZ;
  static constexpr int kCopies = kNodeCopies + kCk;
  static constexpr int kStages = kFloat ? V6_STAGES_F32 : V6_STAGES_F64;
  static_assert(kStages >= 2, "the ring holds node planes k and k+1");
  // dynamic shared memory: the ring, fs, Ke (float) and the copy table
  static constexpr size_t kSmemBytes =
      sizeof(T) * (static_cast<size_t>(kStages) * (kSlot + kCk) +
                   24 * static_cast<size_t>(kF) + kKe) +
      sizeof(int2) * kCopies;
  static_assert(kSmemBytes <= smv::kMaxSmemBytes,
                "above the 227 KB of shared memory a block can have");
};

// Element dof of k column p (0..7) of k step ks: component ks, corner
// (dx, dy, dz) = (p & 1, (p >> 1) & 1, p >> 2), VTK numbered.
__host__ __device__ constexpr int k_dof(int ks, int p) {
  return 3 * (4 * (p >> 2) + (((p >> 1) & 1) ? 3 - (p & 1) : (p & 1))) + ks;
}

__device__ __forceinline__ void mma(double (&d)[4], const double (&a)[4],
                                    const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// The products of one cell plane: fs[d][cell] = ck[cell] * sum_e Ke[d][e] .
// u[cell][e], u gathered from the node planes n0 (dx = 0) and n1 (dx = 1),
// ck from the ck plane ckk.  One specialisation per dtype, chosen at
// compile time.
template <typename T>
struct CellProduct;

// Float: unrolled FFMAs on the CUDA cores.  A thread computes the two
// cells (warp, lane) and (warp + 16, lane) at once, so a warp's loads and
// stores are 32 consecutive values and every Ke value feeds two FMAs.  Ke
// is read from shared memory as float4 broadcasts (copied there from the
// constant bank when the block starts): as constant-bank operands the
// compiler spends a uniform load (ULDC) on every two FFMAs.
template <>
struct CellProduct<float> {
  using L = Layout<float>;
  static_assert(L::kCy == 2 * L::kWarps, "two cells a thread");
  const float4* ke4;

  __device__ CellProduct(int /*lane*/, const float* ke_s)
      : ke4(reinterpret_cast<const float4*>(ke_s)) {}

  __device__ void plane(const float* n0, const float* n1, const float* ckk,
                        float* fs, int warp, int lane) const {
    constexpr int kDc = L::kWarps * kCellsZ, kDn = L::kWarps * L::kRow;
    const int cell = warp * kCellsZ + lane;
    const int node = warp * L::kRow + lane;
    float u[2][24];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          u[j][3 * a + c] =
              (corner_x(a) ? n1 : n0)[c * L::kComp + node + j * kDn +
                                      corner_y(a) * L::kRow + corner_z(a)];
    const float s0 = ckk[cell], s1 = ckk[cell + kDc];
#pragma unroll
    for (int d = 0; d < 24; ++d) {
      float f0 = 0.f, f1 = 0.f;
#pragma unroll
      for (int e4 = 0; e4 < 6; ++e4) {
        const float4 k = ke4[d * 6 + e4];
        f0 = fmaf(k.x, u[0][4 * e4], f0);
        f1 = fmaf(k.x, u[1][4 * e4], f1);
        f0 = fmaf(k.y, u[0][4 * e4 + 1], f0);
        f1 = fmaf(k.y, u[1][4 * e4 + 1], f1);
        f0 = fmaf(k.z, u[0][4 * e4 + 2], f0);
        f1 = fmaf(k.z, u[1][4 * e4 + 2], f1);
        f0 = fmaf(k.w, u[0][4 * e4 + 3], f0);
        f1 = fmaf(k.w, u[1][4 * e4 + 3], f1);
      }
      fs[d * L::kF + cell] = s0 * f0;
      fs[d * L::kF + cell + kDc] = s1 * f1;
    }
  }
};

// Double: DMMA (mma.sync m16n8k8 .f64) on the tensor cores.  An M tile is
// 16 cells along z; warp w of 8 takes M tiles w + 8q.  acc[nt] += U . Ke^T
// for output dofs 8nt..8nt+7 over three k steps; B[k][n] = Ke[8nt + n]
// [k_dof(ks, k)], so lane (g, t) = (lane / 4, lane % 4) holds k = t, t + 4
// at n = g in registers for the block's life, and reads its A fragment -
// corner (dx, dy) = (t & 1, t >> 1), dz = 0 and 1, cells g and g + 8 - at
// offsets fixed per lane.
template <>
struct CellProduct<double> {
  using L = Layout<double>;
  double b[3][3][2];                     // [ks][nt][k half]
  int g, t;

  __device__ CellProduct(int lane, const double* /*ke_s*/)
      : g(lane >> 2), t(lane & 3) {
#pragma unroll
    for (int ks = 0; ks < 3; ++ks)
#pragma unroll
      for (int nt = 0; nt < 3; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          b[ks][nt][h] = ke_f64[(8 * nt + g) * 24 + k_dof(ks, t + 4 * h)];
  }

  __device__ void plane(const double* n0, const double* n1,
                        const double* ckk, double* fs, int warp,
                        int /*lane*/) const {
    const double* const u0 = ((t & 1) ? n1 : n0) + (t >> 1) * L::kRow + g;
#pragma unroll 1
    for (int q = 0; q < 2 * L::kCy / L::kWarps; ++q) {
      const int mt = warp + L::kWarps * q;
      const int cy = mt >> 1, cz0 = (mt & 1) * 16;
      const double* const u = u0 + cy * L::kRow + cz0;
      double a[3][4];
#pragma unroll
      for (int ks = 0; ks < 3; ++ks) {
        const double* const uc = u + ks * L::kComp;
        a[ks][0] = uc[0];       // row g,     k column t     (dz = 0)
        a[ks][1] = uc[8];       // row g + 8, k column t
        a[ks][2] = uc[1];       // row g,     k column t + 4 (dz = 1)
        a[ks][3] = uc[9];       // row g + 8, k column t + 4
      }
      double acc[3][4];
#pragma unroll
      for (int nt = 0; nt < 3; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] = 0.0;
#pragma unroll
      for (int ks = 0; ks < 3; ++ks)
#pragma unroll
        for (int nt = 0; nt < 3; ++nt) mma(acc[nt], a[ks], b[ks][nt]);
      const int cell = cy * kCellsZ + cz0 + g;
      const double s0 = ckk[cell], s1 = ckk[cell + 8];
#pragma unroll
      for (int nt = 0; nt < 3; ++nt) {
        double* const f = fs + (8 * nt + 2 * t) * L::kF + cell;
        f[0] = s0 * acc[nt][0];             // (g, 2t)
        f[L::kF] = s0 * acc[nt][1];         // (g, 2t + 1)
        f[8] = s1 * acc[nt][2];             // (g + 8, 2t)
        f[L::kF + 8] = s1 * acc[nt][3];     // (g + 8, 2t + 1)
      }
    }
  }
};

template <typename T>
__global__ void
__launch_bounds__(Layout<T>::kThreads, Layout<T>::kMinBlocks)
structured_matvec_kernel(const T* __restrict__ x, const T* __restrict__ ck,
                         T* __restrict__ y, int nx, int ny, int nz,
                         int seg_len, int n_ty, int n_tz, int n_seg) {
  using L = Layout<T>;
  constexpr int kStages = L::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const nodes = reinterpret_cast<T*>(smem_raw);   // [kStages][kSlot]
  T* const cks = nodes + kStages * L::kSlot;         // [kStages][kCk]
  T* const fs = cks + kStages * L::kCk;              // [24][kF]
  T* const ke_s = fs + 24 * L::kF;                   // [24 * 24], float
  int2* const table = reinterpret_cast<int2*>(ke_s + L::kKe);  // [kCopies]

  const int nxn = nx + 1, nyn = ny + 1, nzn = nz + 1;
  const int grid = nxn * nyn * nzn;          // nodes of one component grid
  int blk = blockIdx.x;
  const int tz = blk % n_tz;
  blk /= n_tz;
  const int ty = blk % n_ty;
  blk /= n_ty;
  const int seg = blk % n_seg;
  const int p = blk / n_seg;
  // local node (yy, zz) of the tile is global (iy0 - 1 + yy, iz0 - 1 + zz);
  // local cell (cy, cz) likewise; the block owns nodes yy in [1, kCy),
  // zz in [1, 32)
  const int iy0 = ty * (L::kCy - 1), iz0 = tz * (kCellsZ - 1);
  const int x0 = seg * seg_len, x_end = min(x0 + seg_len, nxn);
  const int n_steps = x_end - x0 + 1;      // cell planes x0-1 .. x_end-1
  const int n_node = n_steps + 1;          // node planes x0-1 .. x_end
  const T* const xp = x + static_cast<size_t>(p) * 3 * grid;
  const T* const ckp = ck + static_cast<size_t>(p) * nx * ny * nz;
  T* const yp = y + static_cast<size_t>(p) * 3 * grid;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // The copies of a plane, the same for every plane of the block: entry e
  // holds the source offset within a plane (x: c * grid + gy * nzn + gz;
  // ck: gy * nz + gz), -1 off the grid in y or z, and the destination
  // within a slot.  A thread writes and reads only its own entries.
  for (int e = threadIdx.x; e < L::kCopies; e += L::kThreads) {
    int src, dst;
    if (e < L::kNodeCopies) {
      const int r = e / kNodesZ, zz = e % kNodesZ;
      const int c = r / (L::kCy + 1), yy = r % (L::kCy + 1);
      const int gy = iy0 - 1 + yy, gz = iz0 - 1 + zz;
      const bool ok = gy >= 0 && gy < nyn && gz >= 0 && gz < nzn;
      src = ok ? c * grid + gy * nzn + gz : -1;
      dst = c * L::kComp + yy * L::kRow + zz;
    } else {
      const int r = (e - L::kNodeCopies) / kCellsZ;
      const int zz = (e - L::kNodeCopies) % kCellsZ;
      const int gy = iy0 - 1 + r, gz = iz0 - 1 + zz;
      const bool ok = gy >= 0 && gy < ny && gz >= 0 && gz < nz;
      src = ok ? gy * nz + gz : -1;
      dst = r * kCellsZ + zz;
    }
    table[e] = make_int2(src, dst);
  }
  if constexpr (L::kKe > 0) {
    for (int e = threadIdx.x; e < L::kKe; e += L::kThreads) ke_s[e] = ke_f32[e];
  }

  // node plane x0-1+j and ck plane x0-1+j into slot j % kStages; one
  // commit group per j, empty past the segment
  auto issue = [&](int j) {
    if (j < n_node) {
      const int gp = x0 - 1 + j;
      const int s = j % kStages;
      const bool plane_ok = gp >= 0 && gp < nxn;
      const bool plane_c = gp >= 0 && gp < nx && j < n_steps;
      const T* const xq = xp + (plane_ok ? gp * nyn * nzn : 0);
      const T* const cq = ckp + (plane_c ? gp * ny * nz : 0);
      T* const xs = nodes + s * L::kSlot;
      T* const cs = cks + s * L::kCk;
#pragma unroll 4
      for (int e = threadIdx.x; e < L::kCopies; e += L::kThreads) {
        const int2 d = table[e];
        if (e < L::kNodeCopies) {
          const bool ok = plane_ok && d.x >= 0;
          smv::copy_async(xs + d.y, ok ? xq + d.x : xp, ok);
        } else if (j < n_steps) {
          const bool ok = plane_c && d.x >= 0;
          smv::copy_async(cs + d.y, ok ? cq + d.x : ckp, ok);
        }
      }
    }
    smv::commit_copies();
  };

  const CellProduct<T> prod(lane, ke_s);

  T carry[L::kRowsPerWarp][3];
#pragma unroll
  for (int jr = 0; jr < L::kRowsPerWarp; ++jr)
#pragma unroll
    for (int c = 0; c < 3; ++c) carry[jr][c] = T(0);

  for (int j = 0; j < kStages - 1; ++j) issue(j);
  for (int k = 0; k < n_steps; ++k) {
    // slot (k-1) % kStages was last read before the previous step's second
    // barrier
    issue(k + kStages - 1);
    smv::wait_copies<kStages - 2>();       // node planes k, k+1, ck plane k
    __syncthreads();

    // 1. the cell products of cell plane x0-1+k, scaled by ck, into fs
    prod.plane(nodes + (k % kStages) * L::kSlot,
               nodes + ((k + 1) % kStages) * L::kSlot,
               cks + (k % kStages) * L::kCk, fs, warp, lane);
    __syncthreads();

    // 2. placement: node plane x0-1+k gets the carry plus its dx = 0
    // corners; the dx = 1 corners start the next plane's carry
    const int i = x0 - 1 + k;
    const int zz = 1 + lane, gz = iz0 + lane;
#pragma unroll
    for (int jr = 0; jr < L::kRowsPerWarp; ++jr) {
      const int yy = 1 + warp + L::kWarps * jr;
      if (yy >= L::kCy || lane == 31) continue;
      const int gy = iy0 - 1 + yy;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        T out = carry[jr][c], next = T(0);
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const T v = fs[(3 * b + c) * L::kF +
                         (yy - corner_y(b)) * kCellsZ + zz - corner_z(b)];
          if (corner_x(b)) {
            next += v;
          } else {
            out += v;
          }
        }
        if (k > 0 && gy < nyn && gz < nzn) {
          yp[c * grid + (i * nyn + gy) * nzn + gz] = out;
        }
        carry[jr][c] = next;
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* ck, void* y, int parts, int nx, int ny,
           int nz, int seg_len, int n_ty, int n_tz, int n_seg,
           cudaStream_t stream) {
  using L = Layout<T>;
  const long long blocks =
      static_cast<long long>(parts) * n_seg * n_ty * n_tz;
  if (seg_len < 1 || n_ty < 1 || n_tz < 1 || n_seg < 1 ||
      blocks >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = smv::allow_smem(structured_matvec_kernel<T>, L::kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  structured_matvec_kernel<T><<<static_cast<int>(blocks), L::kThreads,
                                L::kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(ck), static_cast<T*>(y),
      nx, ny, nz, seg_len, n_ty, n_tz, n_seg);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_on(const void* x, const void* ck, void* y, int parts, int nx,
              int ny, int nz, int seg_len, int n_ty, int n_tz, int n_seg,
              int device, void* stream) {
  smv::DeviceScope scope(device);
  if (scope.error() != 0) return scope.error();
  return launch<T>(x, ck, y, parts, nx, ny, nz, seg_len, n_ty, n_tz, n_seg,
                   static_cast<cudaStream_t>(stream));
}

}  // namespace

// C entry points, two per dtype.  stage copies ke (24,24), a contiguous
// device buffer of the entry's dtype, into the constant bank of `device`.
// The matvec takes x (P,3,nx+1,ny+1,nz+1) and ck (P,nx,ny,nz), contiguous
// device buffers of the entry's dtype, and writes y, allocated by the caller
// with x's shape, using the Ke staged last.  The launch geometry comes from
// ops/structured_matvec.py::v6_geometry: seg_len node planes an x segment,
// n_ty x n_tz (y, z) tiles of (kCy - 1) x 31 nodes, n_seg segments.  The
// wrapper checks shapes, dtype and contiguity and keeps every index below
// 2^31.  Each returns the CUDA error code of its copy or launch (0 = done /
// launched).
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
                                     int seg_len, int n_ty, int n_tz,
                                     int n_seg, int device, void* stream) {
  return launch_on<float>(x, ck, y, parts, nx, ny, nz, seg_len, n_ty, n_tz,
                          n_seg, device, stream);
}

extern "C" int structured_matvec_f64(const void* x, const void* ck, void* y,
                                     int parts, int nx, int ny, int nz,
                                     int seg_len, int n_ty, int n_tz,
                                     int n_seg, int device, void* stream) {
  return launch_on<double>(x, ck, y, parts, nx, ny, nz, seg_len, n_ty, n_tz,
                           n_seg, device, stream);
}

// The dynamic shared memory of a block, itemsize 4 (float) or 8 (double),
// for reports (chip_smoke.py prints it).
extern "C" long long structured_matvec_smem_bytes(int itemsize) {
  return static_cast<long long>(itemsize == 8 ? Layout<double>::kSmemBytes
                                              : Layout<float>::kSmemBytes);
}

SMV_ERROR_STRING(structured_matvec)
