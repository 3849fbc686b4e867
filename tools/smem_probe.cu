// Throughput probes of one SM, read with the SM's own clock: how many
// cycles of an SM one warp instruction takes when two 256-thread blocks on
// every SM (16 warps; dynamic shared memory keeps it at two) issue little
// else.  tools/kernel_builds.py::smem_probe builds and runs it for
// tools/v9_kernel_compare.py, which prices the instructions of the matvec
// kernels with it, and tools/v2v3_kernel_compare.py (PERF.md, Findings).
//
// Modes: 0 LDS.32, all lanes one address (broadcast); 1 LDS.128
// broadcast; 2 LDS.32, lanes on consecutive words; 3 LDS.128, lanes on
// consecutive 16-byte words (512 bytes a warp); 4 SHFL.UP by one lane;
// 5 FFMA on registers (the clock's check: 0.25 cycles at 128 FMA lanes an
// SM).  Each instruction feeds one FADD (modes 0-4), 16 independent
// chains a thread.  Modes 6 to 9 count FFMAs: v9's product pattern, a
// float4 of Ke broadcast from shared memory feeding 8 FFMAs into 24
// accumulators (two cells x 12 dofs; 6), and the same FFMAs with Ke from
// registers (7), with Ke as the FFMA's constant operand from a
// __constant__ bank (8) and from a kernel parameter (9).  Modes 8 and 9
// read all 576 values of a Ke (144 float4s) once a loop trip, as a cell
// product does, each value feeding the FFMAs of both cells.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 16;
constexpr int kSmemBytes = 100 * 1024;   // two blocks an SM, not three

__constant__ float ke_bank[576];         // mode 8

struct KeParam {                         // mode 9
  float v[576];
};

template <int Mode>
__global__ void __launch_bounds__(kThreads, 2)
probe_kernel(int iters, float* out, long long* clocks, int* sm,
             const __grid_constant__ KeParam ke) {
  extern __shared__ float4 buf[];        // the first 16 KB are read
  for (int e = threadIdx.x; e < 32 * 32; e += kThreads) {
    buf[e] = make_float4(e, e + 1, e + 2, e + 3);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(buf));
  float acc[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) acc[u] = static_cast<float>(u + lane);
  const float k1 = 1.0001f, k2 = static_cast<float>(lane) * 1e-7f;
  float cell[2][12];                     // modes 6 to 9
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int d = 0; d < 12; ++d) cell[j][d] = 0.f;
  const float u0 = 1.f + 1e-3f * lane, u1 = 2.f - 1e-3f * lane;
  const long long t0 = clock64();
  if (Mode >= 8) {
    for (int i = 0; i < iters; ++i) {
#pragma unroll
      for (int u = 0; u < 144; ++u) {
        const int d = 4 * (u % 3);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float k = Mode == 8 ? ke_bank[4 * u + q] : ke.v[4 * u + q];
          cell[0][d + q] = fmaf(k, u0, cell[0][d + q]);
          cell[1][d + q] = fmaf(k, u1, cell[1][d + q]);
        }
      }
    }
  } else if (Mode >= 6) {
    for (int i = 0; i < iters; ++i) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float4 k;
        if (Mode == 6) {
          const unsigned a = base + 16u * ((i * kUnroll + u) & 1023);
          asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                       : "=f"(k.x), "=f"(k.y), "=f"(k.z), "=f"(k.w)
                       : "r"(a));
        } else {
          k = make_float4(acc[u], k1, k2, acc[(u + 1) % kUnroll]);
        }
        const int d = 4 * (u % 3);
        cell[0][d] = fmaf(k.x, u0, cell[0][d]);
        cell[1][d] = fmaf(k.x, u1, cell[1][d]);
        cell[0][d + 1] = fmaf(k.y, u0, cell[0][d + 1]);
        cell[1][d + 1] = fmaf(k.y, u1, cell[1][d + 1]);
        cell[0][d + 2] = fmaf(k.z, u0, cell[0][d + 2]);
        cell[1][d + 2] = fmaf(k.z, u1, cell[1][d + 2]);
        cell[0][d + 3] = fmaf(k.w, u0, cell[0][d + 3]);
        cell[1][d + 3] = fmaf(k.w, u1, cell[1][d + 3]);
      }
    }
  }
  for (int i = 0; i < (Mode >= 6 ? 0 : iters); ++i) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned row = base + 512u * ((i * kUnroll + u) & 31);
      if (Mode == 0 || Mode == 2) {
        float v;
        const unsigned a = row + (Mode == 2 ? 4u * lane : 0u);
        asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a));
        acc[u] += v;
      } else if (Mode == 1 || Mode == 3) {
        float4 v;
        const unsigned a = row + (Mode == 3 ? 16u * lane : 0u);
        asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                     : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                     : "r"(a));
        acc[u] += v.x;
      } else if (Mode == 4) {
        acc[u] += __shfl_up_sync(0xffffffffu, acc[u], 1);
      } else {
        acc[u] = fmaf(acc[u], k1, k2);
      }
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  float sum = 0.f;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) sum += acc[u];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int d = 0; d < 12; ++d) sum += cell[j][d];
  out[blockIdx.x * kThreads + threadIdx.x] = sum;
  if (threadIdx.x == 0) {
    unsigned id;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
    clocks[2 * blockIdx.x] = t0;
    clocks[2 * blockIdx.x + 1] = t1;
    sm[blockIdx.x] = static_cast<int>(id);
  }
}

template <int Mode>
int run(int iters, int blocks, float* out, long long* clocks, int* sm,
        cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      probe_kernel<Mode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  KeParam ke;
  for (int i = 0; i < 576; ++i) ke.v[i] = 1.f + 1e-3f * (i % 7);
  if (Mode == 8) {
    e = cudaMemcpyToSymbolAsync(ke_bank, ke.v, sizeof(ke.v), 0,
                                cudaMemcpyHostToDevice, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  probe_kernel<Mode><<<blocks, kThreads, kSmemBytes, s>>>(iters, out,
                                                          clocks, sm, ke);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Runs mode `mode` for `iters` loop trips a thread on `blocks` blocks of
// 256 threads: 16 instructions a trip (128 FFMAs in modes 6 and 7, 1152 in
// modes 8 and 9).  out: blocks x 256 floats; clocks: each block's start
// and end (SM clock); sm: each block's SM.  Returns the CUDA error code.
extern "C" int smem_probe(int mode, int iters, int blocks, void* out,
                          void* clocks, void* sm, void* stream) {
  auto* o = static_cast<float*>(out);
  auto* c = static_cast<long long*>(clocks);
  auto* m = static_cast<int*>(sm);
  auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return run<0>(iters, blocks, o, c, m, s);
    case 1: return run<1>(iters, blocks, o, c, m, s);
    case 2: return run<2>(iters, blocks, o, c, m, s);
    case 3: return run<3>(iters, blocks, o, c, m, s);
    case 4: return run<4>(iters, blocks, o, c, m, s);
    case 5: return run<5>(iters, blocks, o, c, m, s);
    case 6: return run<6>(iters, blocks, o, c, m, s);
    case 7: return run<7>(iters, blocks, o, c, m, s);
    case 8: return run<8>(iters, blocks, o, c, m, s);
    case 9: return run<9>(iters, blocks, o, c, m, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
