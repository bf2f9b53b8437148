// Shared helpers of the port's CUDA kernels (plain C interface, no
// PyTorch headers: each source builds with nvcc in seconds).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

constexpr float NEG_INF = -1e30f;   // the reference's masked-score value

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// activation codes shared with the Python wrappers
enum Act { ACT_SILU = 0, ACT_GELU = 1 };

__device__ __forceinline__ float act_fn(float x, int act) {
  if (act == ACT_SILU) return x / (1.0f + expf(-x));
  // jax.nn.gelu's default tanh approximation
  const float c = 0.7978845608028654f;  // sqrt(2/pi)
  return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
}

}  // namespace repro

// Every library exports this so the wrapper can name a failed launch.
extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
