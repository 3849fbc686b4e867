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
//     values, is a compile-time choice, the kernel's template argument
//     (smv::DmmaProduct and smv::FfmaProduct in structured_tiles.cuh):
//     - double: DMMA (mma.sync m16n8k8 .f64), exact IEEE FMAs on the
//       tensor cores, 16 cells along z an M tile.  The K order is permuted
//       so that one k step is one component and a lane's two k columns are
//       the dz = 0, 1 corners of one (dx, dy): its A fragment is four
//       shared-memory loads at offsets fixed per lane.  Ke's B fragments
//       live in registers for the block's life, read once from the
//       constant bank.
//     - float: unrolled FFMAs, two cells a thread (v4 ships the same).
//       Two tensor-core products were built and measured on the card:
//       3xTF32 (hi = tf32(v), lo = tf32(v - hi), lo.hi + hi.lo then hi.hi
//       in a float accumulator; 1xTF32's 10 mantissa bits miss the 2e-5 x
//       max|y| tolerance), within the tolerance and 4 % faster, and DMMA
//       over float nodes (one rounding a cell result, less round-off than
//       FFMA's), 6 % faster.  Under each the flagship solve's second
//       stagnation exit moved from 1568 to ~1350-1370 iterations, 3112
//       and 3131 in all, outside 5 % of the JAX package's 3334 (PERF.md,
//       Findings, which names the commits that hold their sources).
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
// fixed at compile time and held below a block's 227 KB there.  The
// kernel, its launch, smv::Layout and both products live in
// structured_tiles.cuh, shared with v4, v2 and v8
// (structured_matvec_v4.cu, _v2.cu, _v8.cu: v6's float kernel in
// libraries of their own).  The wrapper knows only the tile shape and the
// blocks an SM holds.
//
// Ke is staged into the constant bank by its own entry point, once per Ke:
// the wrapper (ops/structured_matvec.py) restages only when it is handed
// another Ke tensor or the same one changed in place.  Staging ends with a
// stream sync, so every later launch on any stream reads the new Ke; a
// launch with one Ke must not still be running when another Ke is staged.
// The entry points make the tensor's device current for their calls and
// restore the caller's device before they return.

#include <cuda_runtime.h>

#include "structured_tiles.cuh"

namespace {

__constant__ float ke_f32[24 * 24];
__constant__ double ke_f64[24 * 24];

// Float: unrolled FFMAs on the CUDA cores (smv::FfmaProduct), Ke copied
// into shared memory from the constant bank when a block starts.
struct KeF32 {
  __device__ static float at(int i) { return ke_f32[i]; }
};
using FfmaF32Product = smv::FfmaProduct<KeF32>;

// Double: DMMA on the tensor cores (smv::DmmaProduct), Ke's B fragments
// from the constant bank.
struct KeF64 {
  __device__ static double at(int i) { return ke_f64[i]; }
};
using DmmaF64Product = smv::DmmaProduct<KeF64>;

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
  return smv::launch_on<FfmaF32Product>(x, ck, y, parts, nx, ny, nz,
                                        seg_len, n_ty, n_tz, n_seg, device,
                                        stream);
}

extern "C" int structured_matvec_f64(const void* x, const void* ck, void* y,
                                     int parts, int nx, int ny, int nz,
                                     int seg_len, int n_ty, int n_tz,
                                     int n_seg, int device, void* stream) {
  return smv::launch_on<DmmaF64Product>(x, ck, y, parts, nx, ny, nz,
                                        seg_len, n_ty, n_tz, n_seg, device,
                                        stream);
}

// The dynamic shared memory of a block, itemsize 4 (float) or 8 (double),
// for reports (chip_smoke.py prints it).
extern "C" long long structured_matvec_smem_bytes(int itemsize) {
  return static_cast<long long>(itemsize == 8
                                    ? smv::Layout<double>::kSmemBytes
                                    : smv::Layout<float>::kSmemBytes);
}

SMV_ERROR_STRING(structured_matvec)
