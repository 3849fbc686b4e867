// Structured-slab block-stencil matvec for Hopper (sm_90a), float: the
// node-owned gather of structured_gather.cuh (v5's kernel) with this
// library's constant bank of Ke, in chunks of C = PCG_TPU_PALLAS_PLANES
// planes.
//
// Replaces pcg_mpi_solver_tpu/ops/pallas_matvec.py::structured_matvec_pallas_v7
// (kernel _matvec_kernel_v7), which the JAX package's structured backend
// launches for every f32 matvec under PCG_TPU_PALLAS_V=7, and its per-part
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
// kernel.  The FMAs of the cells take 58.0 us on the CUDA cores at 67
// TFLOP/s, 62 us at the 1.07x this gather executes (its idle lanes).
//
// How the TPU kernel maps onto this one: it is a node-owned "roll-only
// gather".  A grid step takes a chunk of C planes of a host-padded slab;
// each output node row gathers, for each corner b, the three rows
// Ke[3b:3b+3] . (ck * u) of the cell whose corner b it is, every shifted
// read a whole-row rotation (pltpu.roll), and carries the dx = 1 rows into
// the next plane.  On Hopper a node-owned gather needs no rotation: a
// thread owns two y-adjacent nodes and reads its cells' corners from a
// node window in registers that slides along x (structured_gather.cuh's
// note), node and ck planes staged by cp.async in a ring of two chunks of
// C planes, the next chunk's copies issued before this chunk's steps.  ck
// scales each cell's product, not u (scaling u moved the flagship solve to
// 3135 iterations, PERF.md).
// Nothing is padded on the host: off-grid values are zero-filled.  Each
// output node plane is written once; no atomics and a fixed summation
// order, so two launches give the same bits, and they are v5's bits at
// every C.
//
// What the kernel this one replaced (a warp a row of 32 z nodes, lanes
// exchanging corners by warp shuffles) spent and this one does not: each
// warp loaded its three y rows straight from global memory, so each node
// row was read by three warps; no staging or prefetch, so every plane's
// loads sat in the dependency chain; 2 of 32 lanes recomputed; Ke read
// from the constant bank an FFMA at a time (here float4 broadcasts from
// shared memory).
//
// The launch geometry is v5's (ops/structured_matvec.py::v5_geometry at
// this C): the tallest tile of 8, 4 or 2 rows whose ring of 2C + 2 slots
// fits 227 KB; a C whose ring does not fit even at 2 rows (C above 54) is
// refused (cudaErrorInvalidConfiguration).  The kernel this one replaced
// used no shared memory and refused no C.
//
// Ke is staged into this library's constant bank by its own entry point
// (the wrapper restages only for another Ke or one changed in place;
// staging ends with a stream sync) and copied into shared memory when a
// block starts.  The entry points make the tensor's device current and
// restore the caller's before they return.

#include <cuda_runtime.h>

#include "structured_gather.cuh"

namespace {

__constant__ float ke_v7[24 * 24];

struct KeV7 {
  __device__ static float at(int i) { return ke_v7[i]; }
};

}  // namespace

// C entry points, as v5's.  stage copies ke (24,24), a contiguous float
// device buffer, into this library's constant bank on `device`.  The
// matvec takes x (P,3,nx+1,ny+1,nz+1) and ck (P,nx,ny,nz), contiguous
// float device buffers, and writes y, allocated by the caller with x's
// shape, using the Ke staged last; `planes` is C and the rest is the
// launch geometry of ops/structured_matvec.py::v5_geometry.  Each returns
// the CUDA error code of its copy or launch (0 = done / launched).
extern "C" int structured_matvec_v7_stage_f32(const void* ke, int device,
                                              void* stream) {
  return smv::stage(ke_v7, ke, device, stream);
}

extern "C" int structured_matvec_v7_f32(const void* x, const void* ck,
                                        void* y, int parts, int nx, int ny,
                                        int nz, int planes, int rows,
                                        int seg_len, int n_ty, int n_tz,
                                        int n_seg, int device, void* stream) {
  return smv::gather::launch<KeV7>(x, ck, y, parts, nx, ny, nz, planes, rows,
                                   seg_len, n_ty, n_tz, n_seg, device,
                                   stream);
}

// The dynamic shared memory of a launch at `planes` and `rows`, for
// reports and the wrapper's mirror check (v5_smem_bytes).
extern "C" long long structured_matvec_v7_smem_bytes(int planes, int rows) {
  return static_cast<long long>(smv::gather::smem_bytes(planes, rows));
}

SMV_ERROR_STRING(structured_matvec_v7)
