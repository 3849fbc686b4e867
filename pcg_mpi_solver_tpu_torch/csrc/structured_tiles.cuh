// The cell-centred tile kernel of the structured-slab matvec, shared by
// structured_matvec.cu (v6, float and double), structured_matvec_v4.cu
// (v4, float), structured_matvec_v2.cu (v2, float) and
// structured_matvec_v8.cu (v8, float): (y, z) node tiles marching x
// segments, node and ck planes staged in a cp.async ring, a cell product
// chosen at compile time, placement through shared memory.
// structured_matvec.cu's note says how the tiles work and why; this header
// holds the layout of each dtype, the kernel, its launch, the two cell
// products, FFMA (float) and DMMA (double), and the phase probe of
// tools/v7v8_kernel_compare.py.  A source chooses a product, with its
// constant bank of Ke, and launches it through launch_on<Product>.

#pragma once

#include <cuda_runtime.h>

#include "structured_common.cuh"

// Ring slots per dtype.  tools/v6_kernel_compare.py --sweep builds the
// kernel at other depths to time them against these.
#ifndef V6_STAGES_F32
#define V6_STAGES_F32 3
#endif
#ifndef V6_STAGES_F64
#define V6_STAGES_F64 4
#endif

namespace smv {

constexpr int kCellsZ = 32;               // cells a tile row
constexpr int kNodesZ = kCellsZ + 1;      // staged nodes a row

// smallest m >= n with m % mod == rem
__host__ __device__ constexpr int pad_to(int n, int rem, int mod) {
  return n + ((rem - n % mod) % mod + mod) % mod;
}

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
  static_assert(kSmemBytes <= kMaxSmemBytes,
                "above the 227 KB of shared memory a block can have");
};

// The phases of a plane that the probe times, in the order a plane runs
// them, and the block's start (the copy table, Ke, the first copies).
enum Phase {
  kPrologue, kIssue, kWait, kBarrier, kProduct, kBarrier2, kPlace, kPhases
};

#ifdef SMV_PHASE_PROBE
// tools/v7v8_kernel_compare.py's builds only: each warp reads the SM clock
// at the end of each phase and adds the cycles since the last read to
// that phase; lane 0 writes the sums to
// phase_cycles[(block * warps + warp) * kPhases + phase].
__device__ unsigned int* phase_cycles;

struct PhaseClock {
  long long t;
  unsigned int acc[kPhases];
  __device__ PhaseClock() {
    for (int p = 0; p < kPhases; ++p) acc[p] = 0;
    t = clock64();
  }
  __device__ void mark(Phase p) {
    const long long now = clock64();
    acc[p] += static_cast<unsigned int>(now - t);
    t = now;
  }
  __device__ void write(int warps, int warp, int lane) const {
    if (lane != 0) return;
    unsigned int* const out =
        phase_cycles + (static_cast<size_t>(blockIdx.x) * warps + warp) *
                           kPhases;
    for (int p = 0; p < kPhases; ++p) out[p] = acc[p];
  }
};
#define SMV_PHASE_START() PhaseClock phase_clock
#define SMV_PHASE(p) phase_clock.mark(p)
#define SMV_PHASE_END(warps, warp, lane) \
  phase_clock.write(warps, warp, lane)
#else
// Every shipped build: the hook is empty.
#define SMV_PHASE_START()
#define SMV_PHASE(p)
#define SMV_PHASE_END(warps, warp, lane)
#endif

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

// The cell product as unrolled FFMAs on the CUDA cores, float only:
// fs[d][cell] = ck[cell] * sum_e Ke[d][e] . u[cell][e], u gathered from the
// node planes n0 (dx = 0) and n1 (dx = 1), ck from the ck plane ckk, each
// result summed and scaled in float.  A thread computes the two cells
// (warp, lane) and (warp + kWarps, lane) at once, so a warp's loads and
// stores are 32 consecutive values and every Ke value feeds two FMAs.  Ke
// is read from shared memory as float4 broadcasts, copied there from its
// library's constant bank (Ke::at(i), element i of the row-major Ke) when
// the block starts.  Read from the constant bank at compile-time indices
// instead, ptxas loads Ke into uniform registers (a ULDC.64 every four
// FFMAs, from a __constant__ bank and from a kernel parameter alike), and
// the kernel ran 1.2 % slower (PERF.md, Findings).
template <class Ke>
struct FfmaProduct {
  using L = Layout<float>;
  using T = float;
  static_assert(L::kCy == 2 * L::kWarps, "two cells a thread");
  static_assert(L::kKe == 24 * 24, "Ke in shared memory");
  const float4* ke4;

  __device__ FfmaProduct(int /*lane*/, float* ke_s)
      : ke4(reinterpret_cast<const float4*>(ke_s)) {
    for (int e = threadIdx.x; e < L::kKe; e += L::kThreads) {
      ke_s[e] = Ke::at(e);
    }
  }

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

// The cell product on the FP64 tensor cores (mma.sync m16n8k8 .f64),
// double only: fs[d][cell] = ck[cell] * sum_e Ke[d][e] . u[cell][e], u
// gathered from the node planes n0 (dx = 0) and n1 (dx = 1), ck from the ck
// plane ckk.  An M tile is 16 cells along z; warp w takes M tiles w +
// kWarps q.  acc[nt] += U . Ke^T for output dofs 8nt..8nt+7 over three k
// steps; B[k][n] = Ke[8nt + n][k_dof(ks, k)], so
// lane (g, t) = (lane / 4, lane % 4) holds k = t, t + 4 at n = g in
// registers for the block's life (Ke::at(i), element i of the row-major
// Ke, from its library's constant bank), and reads its A fragment -
// corner (dx, dy) = (t & 1, t >> 1), dz = 0 and 1, cells g and g + 8 - at
// offsets fixed per lane.
template <class Ke>
struct DmmaProduct {
  using L = Layout<double>;
  using T = double;
  static_assert((2 * L::kCy) % L::kWarps == 0, "whole M tiles a warp");
  double b[3][3][2];                     // [ks][nt][k half]
  int g, t;

  __device__ DmmaProduct(int lane, T* /*ke_s*/)
      : g(lane >> 2), t(lane & 3) {
#pragma unroll
    for (int ks = 0; ks < 3; ++ks)
#pragma unroll
      for (int nt = 0; nt < 3; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          b[ks][nt][h] = Ke::at((8 * nt + g) * 24 + k_dof(ks, t + 4 * h));
  }

  __device__ void plane(const T* n0, const T* n1, const T* ckk, T* fs,
                        int warp, int /*lane*/) const {
    const T* const u0 = ((t & 1) ? n1 : n0) + (t >> 1) * L::kRow + g;
#pragma unroll 1
    for (int q = 0; q < 2 * L::kCy / L::kWarps; ++q) {
      const int mt = warp + L::kWarps * q;
      const int cy = mt >> 1, cz0 = (mt & 1) * 16;
      const T* const u = u0 + cy * L::kRow + cz0;
      double a[3][4];
#pragma unroll
      for (int ks = 0; ks < 3; ++ks) {
        const T* const uc = u + ks * L::kComp;
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
        T* const f = fs + (8 * nt + 2 * t) * L::kF + cell;
        f[0] = s0 * acc[nt][0];                   // (g, 2t)
        f[L::kF] = s0 * acc[nt][1];               // (g, 2t + 1)
        f[8] = s1 * acc[nt][2];                   // (g + 8, 2t)
        f[L::kF + 8] = s1 * acc[nt][3];           // (g + 8, 2t + 1)
      }
    }
  }
};

template <class Product>
__global__ void
__launch_bounds__(Product::L::kThreads, Product::L::kMinBlocks)
structured_matvec_kernel(const typename Product::T* __restrict__ x,
                         const typename Product::T* __restrict__ ck,
                         typename Product::T* __restrict__ y, int nx, int ny,
                         int nz, int seg_len, int n_ty, int n_tz, int n_seg) {
  using L = typename Product::L;
  using T = typename Product::T;
  constexpr int kStages = L::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const nodes = reinterpret_cast<T*>(smem_raw);   // [kStages][kSlot]
  T* const cks = nodes + kStages * L::kSlot;         // [kStages][kCk]
  T* const fs = cks + kStages * L::kCk;              // [24][kF]
  T* const ke_s = fs + 24 * L::kF;                   // [kKe]
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
  SMV_PHASE_START();

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
          copy_async(xs + d.y, ok ? xq + d.x : xp, ok);
        } else if (j < n_steps) {
          const bool ok = plane_c && d.x >= 0;
          copy_async(cs + d.y, ok ? cq + d.x : ckp, ok);
        }
      }
    }
    commit_copies();
  };

  // stages Ke into ke_s if the product reads it from there (read after the
  // first barrier below)
  const Product prod(lane, ke_s);

  T carry[L::kRowsPerWarp][3];
#pragma unroll
  for (int jr = 0; jr < L::kRowsPerWarp; ++jr)
#pragma unroll
    for (int c = 0; c < 3; ++c) carry[jr][c] = T(0);

  for (int j = 0; j < kStages - 1; ++j) issue(j);
  SMV_PHASE(kPrologue);
  for (int k = 0; k < n_steps; ++k) {
    // slot (k-1) % kStages was last read before the previous step's second
    // barrier
    issue(k + kStages - 1);
    SMV_PHASE(kIssue);
    wait_copies<kStages - 2>();            // node planes k, k+1, ck plane k
    SMV_PHASE(kWait);
    __syncthreads();
    SMV_PHASE(kBarrier);

    // 1. the cell products of cell plane x0-1+k, scaled by ck, into fs
    prod.plane(nodes + (k % kStages) * L::kSlot,
               nodes + ((k + 1) % kStages) * L::kSlot,
               cks + (k % kStages) * L::kCk, fs, warp, lane);
    SMV_PHASE(kProduct);
    __syncthreads();
    SMV_PHASE(kBarrier2);

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
    SMV_PHASE(kPlace);
  }
  SMV_PHASE_END(L::kWarps, warp, lane);
}

// Launches the kernel of Product on the current device: x (P, 3, nx+1,
// ny+1, nz+1) and ck (P, nx, ny, nz) contiguous device buffers of the
// product's type, y allocated by the caller with x's shape.  The grid is
// the wrapper's (ops/structured_matvec.py::v6_geometry): seg_len node
// planes an x segment, n_ty x n_tz (y, z) tiles of (kCy - 1) x 31 nodes,
// n_seg segments; a grid that does not cover the slab with this build's
// tile (a wrapper out of step with the source) is refused.  Returns the
// CUDA error code of the launch (0 = launched).
template <class Product>
int launch(const void* x, const void* ck, void* y, int parts, int nx, int ny,
           int nz, int seg_len, int n_ty, int n_tz, int n_seg,
           cudaStream_t stream) {
  using L = typename Product::L;
  using T = typename Product::T;
  const long long blocks =
      static_cast<long long>(parts) * n_seg * n_ty * n_tz;
  if (seg_len < 1 || n_ty != (ny + L::kCy - 1) / (L::kCy - 1) ||
      n_tz != (nz + kCellsZ - 1) / (kCellsZ - 1) ||
      n_seg != (nx + seg_len) / seg_len || blocks >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = allow_smem(structured_matvec_kernel<Product>,
                             L::kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  structured_matvec_kernel<Product><<<static_cast<int>(blocks), L::kThreads,
                                      L::kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(ck), static_cast<T*>(y),
      nx, ny, nz, seg_len, n_ty, n_tz, n_seg);
  return static_cast<int>(cudaGetLastError());
}

// launch() with `device` current, the caller's device restored after.
template <class Product>
int launch_on(const void* x, const void* ck, void* y, int parts, int nx,
              int ny, int nz, int seg_len, int n_ty, int n_tz, int n_seg,
              int device, void* stream) {
  DeviceScope scope(device);
  if (scope.error() != 0) return scope.error();
  return launch<Product>(x, ck, y, parts, nx, ny, nz, seg_len, n_ty, n_tz,
                         n_seg, static_cast<cudaStream_t>(stream));
}

}  // namespace smv

#ifdef SMV_PHASE_PROBE
// Points the phase probe of this library at buf, a device buffer of
// blocks x warps x kPhases unsigned ints, for launches on the current
// device.  Returns the CUDA error code of the copy.
extern "C" int smv_phase_probe_buffer(void* buf) {
  return static_cast<int>(
      cudaMemcpyToSymbol(smv::phase_cycles, &buf, sizeof(buf)));
}
#endif
