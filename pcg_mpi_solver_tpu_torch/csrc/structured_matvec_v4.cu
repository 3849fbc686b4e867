// Structured-slab block-stencil matvec for Hopper (sm_90a), float: v6's
// float kernel (structured_tiles.cuh: v6 float's cell-centred tiles and
// FFMA cell product) in a library of its own.
//
// Replaces pcg_mpi_solver_tpu/ops/pallas_matvec.py::structured_matvec_pallas_v4
// (kernel _matvec_kernel_v4), which the JAX package's structured backend
// launches for every f32 matvec under PCG_TPU_PALLAS_V=4, and its per-part
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
// kernel.  The product has a second ceiling: 3.888 GFLOP at 67 TFLOP/s,
// the rate of the CUDA cores in float and of the FP64 tensor cores alike,
// take 58.0 us (66 us at the 1.14x cells of these tiles).
//
// The TPU kernel's defining step is one (24,24)@(24,m) MXU product per cell
// plane of a chunk.  Here it runs on v6 float's tiles, not the TPU's lane
// runs (structured_matvec.cu's note: (y, z) node tiles marching x
// segments, node and ck planes staged by cp.async in a ring of fixed
// depth, placement through shared memory, no atomics and a fixed
// summation order, so two launches give the same bits).
// PCG_TPU_PALLAS_PLANES, the TPU kernel's chunk, does not apply.
//   * The product is v6 float's, smv::FfmaProduct.  Its counterpart on the
//     FP64 tensor cores (DMMA over the float nodes, widened to double in
//     registers, ck applied in double, each cell result rounded to float
//     once) was built and measured first: within the kernel tolerance,
//     less round-off and 6 % faster on these tiles, but the flagship solve
//     under it stopped its second f32 cycle at 1368 iterations instead of
//     1568, 3131 in all, outside 5 % of the JAX package's 3334, as 3xTF32
//     did under v6 (PERF.md, Findings, which names the commit that holds
//     its source).
//   * ck scales the product, not the inputs: the earlier lane-run v4
//     kernel found that input scaling moves the flagship's stagnation exit
//     by ~200 iterations (PERF.md, Findings).
// Tile: smv::Layout<float>, v6 float's 32 x 32 cells, 512 threads, one
// block an SM, ring depth 3 (ops/structured_matvec.py's float32 entries of
// V6_CELLS_Y and V6_BLOCKS_PER_SM).
//
// Ke is staged into this library's constant bank as float by its own
// entry point (the wrapper restages only for another Ke or one changed in
// place; staging ends with a stream sync).  The entry points make the
// tensor's device current and restore the caller's before they return.

#include <cuda_runtime.h>

#include "structured_tiles.cuh"

namespace {

__constant__ float ke_f32[24 * 24];

struct KeF32 {
  __device__ static float at(int i) { return ke_f32[i]; }
};

using Product = smv::FfmaProduct<KeF32>;

}  // namespace

// C entry points.  stage copies ke (24,24), a contiguous float device
// buffer, into the constant bank of `device`.  The matvec takes x
// (P,3,nx+1,ny+1,nz+1) and ck (P,nx,ny,nz), contiguous float device
// buffers, and writes y, allocated by the caller with x's shape, using the
// Ke staged last; the launch geometry (seg_len, n_ty, n_tz, n_seg) comes
// from ops/structured_matvec.py::v6_geometry, as v6 float's.  Each
// returns the CUDA error code of its copy or launch (0 = done / launched).
extern "C" int structured_matvec_v4_stage_f32(const void* ke, int device,
                                              void* stream) {
  return smv::stage(ke_f32, ke, device, stream);
}

extern "C" int structured_matvec_v4_f32(const void* x, const void* ck,
                                        void* y, int parts, int nx, int ny,
                                        int nz, int seg_len, int n_ty,
                                        int n_tz, int n_seg, int device,
                                        void* stream) {
  return smv::launch_on<Product>(x, ck, y, parts, nx, ny, nz, seg_len, n_ty,
                                 n_tz, n_seg, device, stream);
}

// The dynamic shared memory of a block of itemsize 4 (float; 0 for
// another itemsize: v4 has no other kernel), for reports (chip_smoke.py
// checks it against v6's).
extern "C" long long structured_matvec_v4_smem_bytes(int itemsize) {
  return itemsize == 4
             ? static_cast<long long>(smv::Layout<float>::kSmemBytes)
             : 0;
}

SMV_ERROR_STRING(structured_matvec_v4)
