// Full-sequence GQA attention (prefill) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel): online softmax over KV tiles with masks
// from explicit positions (kpos >= 0; causal kpos <= qpos; window
// kpos > qpos - window), optional tanh softcap; rows with no valid key
// output 0. Accumulation is float32; scores never leave the SM.
//
// What bounds it on an H100: at the serving shapes (S = 128, Dh = 128) it
// is small either way; per (row, kv-head) it reads K/V once and does
// ~4*Sq*Sk*Dh flops over all query rows, which at prefill lengths is below
// the tensor-core crossover for a float32-accumulating SIMT kernel.
//
// Design: one block per (16-row query tile, kv-head, batch row). A query
// "row" is one (position, grouped head) pair, so the G heads of a kv-head
// share every K/V tile the block stages in shared memory. Each of the four
// warps owns four rows; the 32 lanes split the head dimension and every
// score is a warp-wide reduction. KV tiles are a fixed 32 keys whatever the
// padded extent, and keys are visited in ascending order; a masked key is
// skipped, which is exactly the no-op it is in the block update, so the
// result does not depend on how far the KV axis was padded.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int NWARPS = 4;
constexpr int R = 4;                        // query rows per warp
constexpr int ROWS = NWARPS * R;            // query rows per block
constexpr int BKV = 32;                     // keys per shared-memory tile

template <typename T, int EPL>
__global__ void __launch_bounds__(NWARPS * 32)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ qpos,
                  const int* __restrict__ kpos, T* __restrict__ out, int Sq,
                  int Sk, int H, int Hkv, int G, int causal, int window,
                  float softcap, float scale) {
  constexpr int Dh = EPL * 32;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nrows = Sq * G;
  const int row0 = blockIdx.x * ROWS + warp * R;

  float qr[R][EPL];
  float acc[R][EPL];
  float m[R];
  float l[R];
  int qp[R];
  bool live[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    live[r] = row < nrows;
    m[r] = NEG_INF;
    l[r] = 0.f;
    qp[r] = -1;
    size_t off = 0;
    if (live[r]) {
      const int i = row / G;
      const int g = row % G;
      qp[r] = qpos[(size_t)b * Sq + i];
      off = (((size_t)b * Sq + i) * H + (size_t)hk * G + g) * Dh + lane;
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      acc[r][e] = 0.f;
      qr[r][e] = live[r] ? to_f(q[off + 32 * e]) * scale : 0.f;
    }
  }

  __shared__ float ks[BKV][Dh];
  __shared__ float vs[BKV][Dh];
  __shared__ int kps[BKV];
  for (int j0 = 0; j0 < Sk; j0 += BKV) {
    for (int idx = threadIdx.x; idx < BKV * Dh; idx += NWARPS * 32) {
      const int jj = idx / Dh;
      const int d = idx % Dh;
      const int j = j0 + jj;
      float kv = 0.f, vv = 0.f;
      if (j < Sk) {
        const size_t off = (((size_t)b * Sk + j) * Hkv + hk) * Dh + d;
        kv = to_f(k[off]);
        vv = to_f(v[off]);
      }
      ks[jj][d] = kv;
      vs[jj][d] = vv;
    }
    for (int jj = threadIdx.x; jj < BKV; jj += NWARPS * 32)
      kps[jj] = j0 + jj < Sk ? kpos[(size_t)b * Sk + j0 + jj] : -1;
    __syncthreads();
    const int jn = min(BKV, Sk - j0);
    for (int jj = 0; jj < jn; ++jj) {
      const int kp = kps[jj];
      if (kp < 0) continue;                     // block-uniform
      float kr[EPL], vr[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        kr[e] = ks[jj][lane + 32 * e];
        vr[e] = vs[jj][lane + 32 * e];
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        bool valid = live[r];
        if (causal) valid = valid && kp <= qp[r];
        if (window) valid = valid && kp > qp[r] - window;
        if (!valid) continue;                   // warp-uniform
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) s += qr[r][e] * kr[e];
        s = warp_sum(s);
        if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
        const float m_new = fmaxf(m[r], s);
        const float corr = expf(m[r] - m_new);
        const float pe = expf(s - m_new);
        l[r] = l[r] * corr + pe;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][e] = acc[r][e] * corr + pe * vr[e];
        m[r] = m_new;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (!live[r]) continue;
    const int row = row0 + r;
    const int i = row / G;
    const int g = row % G;
    const size_t off = (((size_t)b * Sq + i) * H + (size_t)hk * G + g) * Dh + lane;
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      store(&out[off + 32 * e],
            l[r] > 0.f ? acc[r][e] / fmaxf(l[r], 1e-30f) : 0.f);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* qpos, const int* kpos, void* out, int B, int Sq,
                   int Sk, int H, int Hkv, int Dh, int causal, int window,
                   float softcap, cudaStream_t st) {
  const int G = H / Hkv;
  const float scale = 1.0f / sqrtf((float)Dh);
  const dim3 grid((Sq * G + ROWS - 1) / ROWS, Hkv, B);
  const dim3 block(NWARPS * 32);
#define FLASH_ARGS                                                         \
  (const T*)q, (const T*)k, (const T*)v, qpos, kpos, (T*)out, Sq, Sk, H,   \
      Hkv, G, causal, window, softcap, scale
  switch (Dh) {
    case 32: flash_attn_kernel<T, 1><<<grid, block, 0, st>>>(FLASH_ARGS); break;
    case 64: flash_attn_kernel<T, 2><<<grid, block, 0, st>>>(FLASH_ARGS); break;
    case 128: flash_attn_kernel<T, 4><<<grid, block, 0, st>>>(FLASH_ARGS); break;
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_ARGS
  return cudaGetLastError();
}

}  // namespace

// q [B,Sq,H,Dh]; k/v [B,Sk,Hkv,Dh]; qpos [B,Sq], kpos [B,Sk] int32 (-1 =
// invalid) -> out [B,Sq,H,Dh]; all contiguous. dtype 0 = float32,
// 1 = bfloat16. Returns cudaGetLastError() after the launch.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               const void* qpos, const void* kpos, void* out,
                               int B, int Sq, int Sk, int H, int Hkv, int Dh,
                               int causal, int window, float softcap,
                               int dtype, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(q, k, v, (const int*)qpos, (const int*)kpos, out, B,
                        Sq, Sk, H, Hkv, Dh, causal, window, softcap, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(q, k, v, (const int*)qpos, (const int*)kpos,
                                out, B, Sq, Sk, H, Hkv, Dh, causal, window,
                                softcap, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
