// Pieces shared by the structured-slab matvec kernels (structured_matvec*.cu):
// the VTK hexahedron corner offsets, the device scope every C entry point
// runs its CUDA calls in, the staging of Ke into a library's constant
// bank, the dynamic shared memory opt-in and the cp.async helpers.  Each
// .cu is built into its own shared library, so each holds its own
// constant bank and stages its own copy of Ke.

#pragma once

#include <cuda_runtime.h>

namespace smv {

// VTK hexahedron corner offsets (models/element.py HEX_CORNERS).
__host__ __device__ constexpr int corner_x(int a) {
  return (a == 1 || a == 2 || a == 5 || a == 6) ? 1 : 0;
}
__host__ __device__ constexpr int corner_y(int a) {
  return (a == 2 || a == 3 || a == 6 || a == 7) ? 1 : 0;
}
__host__ __device__ constexpr int corner_z(int a) { return a >= 4 ? 1 : 0; }

// Makes `device` current for the life of the object, then restores the
// caller's device.
class DeviceScope {
 public:
  explicit DeviceScope(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) {
      err_ = cudaSetDevice(device);
      switched_ = err_ == cudaSuccess;
    }
  }
  ~DeviceScope() {
    if (switched_) cudaSetDevice(prev_);
  }
  int error() const { return static_cast<int>(err_); }

 private:
  int prev_ = 0;
  bool switched_ = false;
  cudaError_t err_;
};

// Copies ke, a contiguous (24, 24) device buffer, into the constant bank
// `symbol` of `device`, and waits for the copy: every later launch on any
// stream reads the new Ke.  A launch with the old Ke must not still be
// running.
template <typename T>
int stage(const T& symbol, const void* ke, int device, void* stream) {
  DeviceScope scope(device);
  if (scope.error() != 0) return scope.error();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemcpyToSymbolAsync(symbol, ke, sizeof(symbol), 0,
                                          cudaMemcpyDeviceToDevice, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaStreamSynchronize(s));
}

// The shared memory a Hopper block can have: 227 KB.
constexpr size_t kMaxSmemBytes = 232448;

// Sets a kernel's dynamic shared memory to `bytes` (needed above 48 KB) or
// refuses a size above kMaxSmemBytes.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > kMaxSmemBytes) return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// cp.async of one float into shared memory; src_ok false fills the
// destination with 0 (src must still be a valid address).
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool src_ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_ok ? 4 : 0)
               : "memory");
}

// cp.async of one double into shared memory; src_ok false fills the
// destination with 0 (src must still be a valid address).
__device__ __forceinline__ void copy8(double* dst, const double* src,
                                      bool src_ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(src_ok ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           bool src_ok) {
  copy4(dst, src, src_ok);
}
__device__ __forceinline__ void copy_async(double* dst, const double* src,
                                           bool src_ok) {
  copy8(dst, src, src_ok);
}

// Closes the group of cp.asyncs issued since the last commit.
__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `Pending` committed groups of this thread are still
// in flight (a __syncthreads must follow before other threads' copies are
// read).
template <int Pending>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

}  // namespace smv

// The C error-string entry point of one kernel library.
#define SMV_ERROR_STRING(prefix)                                  \
  extern "C" const char* prefix##_error_string(int code) {        \
    return cudaGetErrorString(static_cast<cudaError_t>(code));    \
  }
