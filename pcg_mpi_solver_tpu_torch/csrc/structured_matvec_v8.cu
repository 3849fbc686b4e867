// Structured-slab block-stencil matvec for Hopper (sm_90a), float: v6's
// float kernel (structured_tiles.cuh: v6 float's cell-centred tiles and
// FFMA cell product) in a library of its own.
//
// Replaces pcg_mpi_solver_tpu/ops/pallas_matvec.py::structured_matvec_pallas_v8
// (kernel _matvec_kernel_v8), which the JAX package's structured backend
// launches for every f32 matvec under PCG_TPU_PALLAS_V=8, and its per-part
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
// kernel.  The FMAs of the cells (3.888 GFLOP) take 58.0 us on the CUDA
// cores at 67 TFLOP/s, 66 us at the 1.14x cells of these tiles at 150^3.
//
// How the TPU kernel maps onto this one: it is v6's kernel with the plane
// loop made a grid axis, so that its compiler keeps one plane's
// temporaries live instead of a chunk's, and the output block stays
// resident across a chunk's planes.  On Hopper the plane loop is already
// a loop inside the block: v6's tiles march x segments with the carry in
// registers and node and ck planes staged by cp.async in a ring of fixed
// depth (structured_matvec.cu's note), so v8 is that kernel, and gives v6
// float's bits.  PCG_TPU_PALLAS_PLANES, the TPU kernel's chunk, does not
// apply.
//
// A split-phase plane schedule on these tiles (two product buffers, the
// product of plane k beside the placement of plane k - 1, one barrier a
// plane) was built and measured first, on a 24 x 32-cell tile, since two
// buffers do not fit v6's: it ran at the time of v6's schedule on that
// tile and 14 % slower than v6's 32-row tile.  A clock64 probe of v6 float
// at 150^3 (the SMV_PHASE hooks of structured_tiles.cuh) puts 0.3 % of
// its warp-cycles in its two barriers and ring waits: every warp runs the
// same work and reaches each barrier with the others, so there is no
// drain for a split schedule to fill.  PERF.md, Findings, holds the times
// and names the commit that holds that source.
//
// What the kernel this one replaced (a thread a cell of 8 x 32 cell
// tiles) spent and this one does not: a chunk's planes loaded by plain
// loads with div/mod index math into one buffer, then a barrier (no
// overlap of copy and compute); eight read-modify-write placement passes
// a plane into a shared output block, each behind a barrier; one FMA a Ke
// value; 1.18x the product's FMAs on 8 x 32 tiles; 20 bytes spilled.
// Tile: smv::Layout<float>, v6 float's 32 x 32 cells, 512 threads, one
// block an SM, ring depth 3 (ops/structured_matvec.py's float32 entries of
// V6_CELLS_Y and V6_BLOCKS_PER_SM); a grid that is not this tile is
// refused.
//
// Ke is staged into this library's constant bank as float by its own
// entry point (the wrapper restages only for another Ke or one changed in
// place; staging ends with a stream sync) and copied into shared memory
// when a block starts.  The entry points make the tensor's device current
// and restore the caller's before they return.

#include <cuda_runtime.h>

#include "structured_tiles.cuh"

namespace {

__constant__ float ke_v8[24 * 24];

struct KeV8 {
  __device__ static float at(int i) { return ke_v8[i]; }
};

using Product = smv::FfmaProduct<KeV8>;

}  // namespace

// C entry points.  stage copies ke (24,24), a contiguous float device
// buffer, into the constant bank of `device`.  The matvec takes x
// (P,3,nx+1,ny+1,nz+1) and ck (P,nx,ny,nz), contiguous float device
// buffers, and writes y, allocated by the caller with x's shape, using the
// Ke staged last; the launch geometry (seg_len, n_ty, n_tz, n_seg) comes
// from ops/structured_matvec.py::v6_geometry, as v6 float's.  Each
// returns the CUDA error code of its copy or launch (0 = done / launched).
extern "C" int structured_matvec_v8_stage_f32(const void* ke, int device,
                                              void* stream) {
  return smv::stage(ke_v8, ke, device, stream);
}

extern "C" int structured_matvec_v8_f32(const void* x, const void* ck,
                                        void* y, int parts, int nx, int ny,
                                        int nz, int seg_len, int n_ty,
                                        int n_tz, int n_seg, int device,
                                        void* stream) {
  return smv::launch_on<Product>(x, ck, y, parts, nx, ny, nz, seg_len, n_ty,
                                 n_tz, n_seg, device, stream);
}

// The dynamic shared memory of a block of itemsize 4 (float; 0 for
// another itemsize: v8 has no other kernel), for reports (chip_smoke.py
// checks it against v6's).
extern "C" long long structured_matvec_v8_smem_bytes(int itemsize) {
  return itemsize == 4
             ? static_cast<long long>(smv::Layout<float>::kSmemBytes)
             : 0;
}

SMV_ERROR_STRING(structured_matvec_v8)
