// Helpers shared by the LSTM kernels (lstm_fwd.cu, lstm_bwd.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace pgasr {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

// Error codes of our own; positive codes are cudaError_t values.
constexpr int kErrUnsupportedH = -1;    // H above 2 x #SMs, or odd and above #SMs
constexpr int kErrGridNotResident = -2; // cooperative grid cannot be co-resident
constexpr int kErrSharedMemory = -3;    // per-block shared memory above the limit
constexpr int kErrDtype = -4;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// value rounded to T and widened back (exact in float32)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

// load through L2 only (ld.global.cg): the value was written by another
// block during this launch, and L1 may still hold an older copy
template <typename T> __device__ __forceinline__ float ldcg_f32(const T* p);
template <> __device__ __forceinline__ float ldcg_f32<float>(const float* p) {
  return __ldcg(p);
}
template <> __device__ __forceinline__ float ldcg_f32<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// Checks a cooperative launch of `grid` blocks of kThreads with `smem`
// bytes of dynamic shared memory: raises the kernel's shared-memory limit
// and verifies the grid can be co-resident. Returns 0 or an error code.
template <typename Kernel>
int prepare_cooperative(Kernel kernel, size_t smem, int grid, int dev, int sms) {
  int smem_max = 0, per_sm = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  if (smem > (size_t)smem_max) return kErrSharedMemory;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return e;
  if (grid > per_sm * sms) return kErrGridNotResident;
  return 0;
}

// Device ordinal and SM count of the current device.
inline int device_sms(int* dev, int* sms) {
  cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, *dev);
}

}  // namespace pgasr
