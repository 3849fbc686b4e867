// Structured-slab block-stencil matvec for Hopper (sm_90a), float: v6's
// float kernel (structured_tiles.cuh: v6 float's cell-centred tiles and
// FFMA cell product) in a library of its own.
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
// What bounds it on an H100 SXM (chip_smoke.py::matvec_bound_ms): at the
// flagship 150^3 slab the bytes (x and y once per node, ck once per cell:
// 96.13 MB) take 28.7 us at 3.35 TB/s, the bound of any float-accurate
// kernel.  The FMAs of the cells (3.888 GFLOP) take 58.0 us on the CUDA
// cores at 67 TFLOP/s, 66 us at the 1.14x cells these tiles compute.
//
// How the TPU kernel maps onto this one: it flattens a node plane into
// lanes, does one (24,24)@(24,m) product V = Ke . (ck * U) a cell plane,
// then adds V's eight corner rows onto the node lanes at their offsets,
// carrying the dx = 1 rows into the next plane.  That is a cell product
// followed by placement, which is what v6's tiles do: (y, z) node tiles
// marching x segments, node and ck planes staged by cp.async in a ring,
// the cell product of a plane into shared memory, each owned node summing
// its corners' rows in a fixed order with the dx = 1 half carried in
// registers (structured_matvec.cu's note).  No atomics and a fixed
// summation order: two launches give the same bits, and they are v6
// float's.  The TPU kernel takes no chunk, and neither does this one.
//
// What the kernel this one replaced spent and this one does not: 1.59x
// the product's FMAs at 150^3 (each 256-lane block also computed the
// nz + 2 halo lanes before it; here 1.14x), a second pass of 152 of 256
// threads over 408 cells, a division a staged value and three barriers a
// plane with synchronous loads (here a copy table, cp.async and two
// barriers), all 24 V rows through shared memory for one lane each.
//
// The cell product is smv::FfmaProduct, as v6 float's and v4's.  A product
// with v6 float's arithmetic (the same bits) but Ke as each FFMA's
// constant operand at a compile-time index was built for v2 and timed in
// turns against this one on the same tiles (PERF.md, Findings, which names
// the commit that holds its source): from the library's __constant__
// bank and from a 2304-byte kernel parameter alike, ptxas loads Ke into
// uniform registers (a ULDC.64 every four FFMAs; no FFMA took a
// c[bank][offset] operand), and the kernel was 1.2 % slower with the bank
// (128 registers against 104) and 28 % slower with the parameter.  So v2
// ships the FFMA product with Ke as float4 broadcasts from shared memory.
//
// Ke is staged into this library's constant bank as float by its own
// entry point (the wrapper restages only for another Ke or one changed in
// place; staging ends with a stream sync) and copied into shared memory
// when a block starts.  The entry points make the tensor's device current
// and restore the caller's before they return.

#include <cuda_runtime.h>

#include "structured_tiles.cuh"

namespace {

__constant__ float ke_v2[24 * 24];

struct KeV2 {
  __device__ static float at(int i) { return ke_v2[i]; }
};

using Product = smv::FfmaProduct<KeV2>;

}  // namespace

// C entry points.  stage copies ke (24,24), a contiguous float device
// buffer, into the constant bank of `device`.  The matvec takes x
// (P,3,nx+1,ny+1,nz+1) and ck (P,nx,ny,nz), contiguous float device
// buffers, and writes y, allocated by the caller with x's shape, using the
// Ke staged last; the launch geometry (seg_len, n_ty, n_tz, n_seg) comes
// from ops/structured_matvec.py::v6_geometry, as v6 float's, and a grid
// that is not this library's tile is refused.  Each returns the CUDA error
// code of its copy or launch (0 = done / launched).
extern "C" int structured_matvec_v2_stage_f32(const void* ke, int device,
                                              void* stream) {
  return smv::stage(ke_v2, ke, device, stream);
}

extern "C" int structured_matvec_v2_f32(const void* x, const void* ck,
                                        void* y, int parts, int nx, int ny,
                                        int nz, int seg_len, int n_ty,
                                        int n_tz, int n_seg, int device,
                                        void* stream) {
  return smv::launch_on<Product>(x, ck, y, parts, nx, ny, nz, seg_len, n_ty,
                                 n_tz, n_seg, device, stream);
}

// The dynamic shared memory of a block of itemsize 4 (float; 0 for
// another itemsize: v2 has no other kernel), for reports (chip_smoke.py
// checks it against v6 float's: the same tiles and ring).
extern "C" long long structured_matvec_v2_smem_bytes(int itemsize) {
  return itemsize == 4
             ? static_cast<long long>(smv::Layout<float>::kSmemBytes)
             : 0;
}

SMV_ERROR_STRING(structured_matvec_v2)
