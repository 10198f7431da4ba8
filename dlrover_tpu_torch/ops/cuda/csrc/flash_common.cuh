// Shared building blocks of the three flash-attention kernels (sm_90a).
//
// Layouts, as the Python wrapper hands them over (all contiguous):
//   q, o, dO, dq : [B, S, H,   D] bf16
//   k, v, dk, dv : [B, S, KVH, D] bf16   (query head h reads kv head h / G)
//   lse, delta   : [B, H, S]      fp32
//
// Products take bf16 operands into fp32 accumulators (flash_sm90.cuh);
// P and dS are rounded to bf16 where the TPU kernels cast them
// (`.astype(v.dtype)` etc.).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float kNegInf = -1e30f;  // the TPU kernels' NEG_INF

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two fp32 values -> one register of two bf16 (round to nearest even),
// the lower column in the low half as mma fragments expect.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Sum over the 4 threads of a quad (the threads that share an mma row).
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return x;
}

// Raise the dynamic shared memory limit of `kernel` when it needs more
// than the default 48 KB.
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace flash
