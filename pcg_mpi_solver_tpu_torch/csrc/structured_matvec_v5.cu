// Structured-slab block-stencil matvec for Hopper (sm_90a), float: the
// node-owned gather of structured_gather.cuh with this library's constant
// bank of Ke.  Each thread owns two output nodes and gathers the eight
// corner products that land on them; no placement pass, no barrier
// between corners, no atomics.
//
// Replaces pcg_mpi_solver_tpu/ops/pallas_matvec.py::structured_matvec_pallas_v5
// (kernel _matvec_kernel_v5), which the JAX package's structured backend
// launches for every f32 matvec under PCG_TPU_PALLAS_V=5, and its per-part
// dispatch batched_structured_matvec: one launch covers the part axis.
//
// Function (StructuredOps.matvec_local, one slab per part p):
//   y[p] = sum_b shift_b( sum_a Ke[3b:3b+3, 3a:3a+3] . (ck[p] * x[p]_a) )
// x, y: (P, 3, nx+1, ny+1, nz+1); ck: (P, nx, ny, nz); Ke: (24, 24) in
// element-dof order 3*corner + comp, corners in VTK order.
//
// What bounds it (structured_gather.cuh): the bytes, 28.7 us at 150^3 on
// an H100 SXM; its FMAs on the CUDA cores set its floor, 59 us (1.07x the
// cells' 58.0 us with the idle lanes of its tiles).
//
// How it maps onto the TPU kernel: the TPU kernel takes, per cell plane and
// per output corner b, the (3,24)@(24,m) product Ke[3b:3b+3] . u of every
// cell (u = the cell's 24 corner values), rolls it onto the lanes of the
// nodes at corner b and adds it, dx = 1 rows carried into the next plane.
// Here the loop is turned around: node n takes, for each b, the same three
// rows Ke[3b:3b+3] . u of the cell n - off_b, scaled by that cell's ck
// (ck scales the product, not u: scaling u moved the flagship to 3135
// iterations, PERF.md), and adds them to its three accumulators in a fixed
// b order.  Per node that is 8 x 3 x 24 = 576 FMAs, one cell's product: no
// cell is computed twice.  What PR 3's kernel of this file did and this one
// does not:
//   * eight __syncthreads per cell plane and 256-cell pass, one before each
//     corner's placement into shared-memory accumulators: there is no
//     placement; a node's sum stays in its thread's registers;
//   * 1.30x halo cells recomputed at 150^3 (1.79x at 16 planes): each node
//     is computed once; the only waste is the lanes of a tile that fall off
//     the grid (151 of 152 rows, 151 of 160 z columns at 150^3: 1.07x);
//   * shared-memory rows padded to 128 floats (the TPU's VMEM rows):
//     rows hold exactly the tile's 34 nodes or 33 cells;
//   * Ke from the constant bank as an operand of every FFMA (a ULDC per two
//     FFMAs): Ke is read from shared memory as float4 broadcasts, each value
//     feeding the FMAs of both nodes of the thread.
//
// The design (tiles of two-node threads, a ring of two chunks, the node
// window in registers) is in structured_gather.cuh, shared with v3
// (structured_matvec_v3.cu) and v7 (structured_matvec_v7.cu).

#include <cuda_runtime.h>

#include "structured_gather.cuh"

namespace {

__constant__ float ke_v5[24 * 24];

struct KeV5 {
  __device__ static float at(int i) { return ke_v5[i]; }
};

}  // namespace

// C entry points.  stage copies ke (24,24), a contiguous float device
// buffer, into this library's constant bank on `device`.  The matvec takes
// x (P,3,nx+1,ny+1,nz+1) and ck (P,nx,ny,nz), contiguous float device
// buffers, and writes y, allocated by the caller with x's shape, using the
// Ke staged last; `planes` is C (PCG_TPU_PALLAS_PLANES) and the rest is the
// launch geometry of ops/structured_matvec.py::v5_geometry: tiles of `rows`
// (8, 4 or 2) x 32 nodes, n_ty x n_tz of them, n_seg x segments of
// seg_len node planes.  The wrapper checks shapes, dtype and contiguity and
// keeps every index below 2^31.  Each returns the CUDA error code of its
// copy or launch (0 = done / launched).
extern "C" int structured_matvec_v5_stage_f32(const void* ke, int device,
                                              void* stream) {
  return smv::stage(ke_v5, ke, device, stream);
}

extern "C" int structured_matvec_v5_f32(const void* x, const void* ck,
                                        void* y, int parts, int nx, int ny,
                                        int nz, int planes, int rows,
                                        int seg_len, int n_ty, int n_tz,
                                        int n_seg, int device, void* stream) {
  return smv::gather::launch<KeV5>(x, ck, y, parts, nx, ny, nz, planes, rows,
                                   seg_len, n_ty, n_tz, n_seg, device,
                                   stream);
}

// The dynamic shared memory of a launch at `planes` and `rows`, for
// reports and the wrapper's mirror check.
extern "C" long long structured_matvec_v5_smem_bytes(int planes, int rows) {
  return static_cast<long long>(smv::gather::smem_bytes(planes, rows));
}

SMV_ERROR_STRING(structured_matvec_v5)
