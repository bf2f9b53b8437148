// Fused GQA decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention_fused (_decode_attn_fused_kernel): one query token per
// row against its cached K/V (mask cpos >= 0 & cpos <= pos, optional
// sliding window and tanh softcap), the current token's (k1, v1) folded in
// at the end, then normalised. Accumulation is float32.
//
// What bounds it on an H100: bytes. Each (row, kv-head) reads its valid
// cache slice once (2 * Dh values per position) and does ~4 flops per
// value read, far below the ~295 flops/byte where the tensor cores would
// matter. At serving batch sizes the grid is small (B * Hkv blocks), so in
// practice latency bounds it: the design keeps many independent loads and
// reductions in flight per warp.
//
// Design: one block per (kv-head, row). The G query heads that share the
// kv-head are packed into the block, so each K/V element is read from
// device memory once for all G of them. Eight warps take groups of NJ = 4
// consecutive cache positions round-robin; inside a warp the 32 lanes
// split the head dimension (lane l owns elements l, l+32, ...: coalesced
// loads), the 4 * G scores of a group are warp-wide reductions interleaved
// for instruction-level parallelism, and the warp's online softmax (m, l,
// acc) takes one rescale per group. A masked position contributes exactly
// nothing (probability 0, max unchanged), as in the block update. The
// warps' partials merge through shared memory, and the epilogue folds
// (k1, v1) and normalises. The TPU kernel's sequential kv-block grid axis
// becomes the loop inside the block; nothing crosses blocks.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int NWARPS = 8;
constexpr int NJ = 4;                       // cache positions per warp step

template <typename T, int EPL, int G>
__global__ void __launch_bounds__(NWARPS * 32)
decode_attn_fused_kernel(const T* __restrict__ q, const T* __restrict__ ck,
                         const T* __restrict__ cv,
                         const int* __restrict__ cpos,
                         const T* __restrict__ k1, const T* __restrict__ v1,
                         const int* __restrict__ pos, T* __restrict__ out,
                         int H, int Hkv, int Sc, int window, float softcap,
                         float scale) {
  constexpr int Dh = EPL * 32;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p = pos[b];

  float qr[G][EPL];
  float acc[G][EPL];
  float m[G];
  float l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
    const size_t off = ((size_t)b * H + (size_t)hk * G + g) * Dh + lane;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      acc[g][e] = 0.f;
      qr[g][e] = to_f(q[off + 32 * e]) * scale;
    }
  }

  const size_t stride = (size_t)Hkv * Dh;   // between cache positions
  const size_t base = ((size_t)b * Sc * Hkv + hk) * Dh + lane;
  const int* cp_row = cpos + (size_t)b * Sc;
  for (int j0 = warp * NJ; j0 < Sc; j0 += NWARPS * NJ) {
    bool valid[NJ];
    float kr[NJ][EPL], vr[NJ][EPL];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int j = j0 + jj;
      const int cp = j < Sc ? cp_row[j] : -1;
      valid[jj] = cp >= 0 && cp <= p && (!window || cp > p - window);
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        kr[jj][e] = valid[jj] ? to_f(ck[base + j * stride + 32 * e]) : 0.f;
        vr[jj][e] = valid[jj] ? to_f(cv[base + j * stride + 32 * e]) : 0.f;
      }
    }
    bool any = false;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) any = any || valid[jj];
    if (!any) continue;                       // warp-uniform
    float s[NJ][G];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float t = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) t += qr[g][e] * kr[jj][e];
        s[jj][g] = t;
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)          // NJ * G reductions at once
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int g = 0; g < G; ++g)
          s[jj][g] += __shfl_xor_sync(0xffffffffu, s[jj][g], o);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float m_new = m[g];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        if (softcap > 0.f) s[jj][g] = tanhf(s[jj][g] / softcap) * softcap;
        if (valid[jj]) m_new = fmaxf(m_new, s[jj][g]);
      }
      const float corr = expf(m[g] - m_new);
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= corr;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float pe = valid[jj] ? expf(s[jj][g] - m_new) : 0.f;
        l[g] += pe;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] += pe * vr[jj][e];
      }
      m[g] = m_new;
    }
  }

  __shared__ float sm_m[NWARPS][G];
  __shared__ float sm_l[NWARPS][G];
  __shared__ float sm_acc[NWARPS][G][Dh];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[warp][g][lane + 32 * e] = acc[g][e];
  }
  __syncthreads();

  // epilogue: merge the warps' partials, fold the current token, normalise
  for (int g = warp; g < G; g += NWARPS) {
    float mm = NEG_INF;
    for (int w = 0; w < NWARPS; ++w) mm = fmaxf(mm, sm_m[w][g]);
    float ll = 0.f;
    float a[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) a[e] = 0.f;
    for (int w = 0; w < NWARPS; ++w) {
      const float c = expf(sm_m[w][g] - mm);
      ll += sm_l[w][g] * c;
#pragma unroll
      for (int e = 0; e < EPL; ++e) a[e] += sm_acc[w][g][lane + 32 * e] * c;
    }
    const size_t qoff = ((size_t)b * H + (size_t)hk * G + g) * Dh + lane;
    const size_t koff = ((size_t)b * Hkv + hk) * Dh + lane;
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      s += to_f(q[qoff + 32 * e]) * scale * to_f(k1[koff + 32 * e]);
    s = warp_sum(s);
    if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
    const float m_f = fmaxf(mm, s);
    const float corr = expf(mm - m_f);
    const float ps = expf(s - m_f);
    const float denom = fmaxf(ll * corr + ps, 1e-30f);
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const float o = (a[e] * corr + ps * to_f(v1[koff + 32 * e])) / denom;
      store(&out[qoff + 32 * e], o);
    }
  }
}

template <typename T, int EPL>
cudaError_t launch_g(const void* q, const void* ck, const void* cv,
                     const int* cpos, const void* k1, const void* v1,
                     const int* pos, void* out, int B, int H, int Hkv,
                     int Sc, int window, float softcap, cudaStream_t st) {
  const float scale = 1.0f / sqrtf((float)(EPL * 32));
  const dim3 grid(Hkv, B);
  const dim3 block(NWARPS * 32);
#define DECODE_ARGS                                                        \
  (const T*)q, (const T*)ck, (const T*)cv, cpos, (const T*)k1,             \
      (const T*)v1, pos, (T*)out, H, Hkv, Sc, window, softcap, scale
  switch (H / Hkv) {
    case 1: decode_attn_fused_kernel<T, EPL, 1><<<grid, block, 0, st>>>(DECODE_ARGS); break;
    case 2: decode_attn_fused_kernel<T, EPL, 2><<<grid, block, 0, st>>>(DECODE_ARGS); break;
    case 4: decode_attn_fused_kernel<T, EPL, 4><<<grid, block, 0, st>>>(DECODE_ARGS); break;
    case 8: decode_attn_fused_kernel<T, EPL, 8><<<grid, block, 0, st>>>(DECODE_ARGS); break;
    default: return cudaErrorInvalidValue;
  }
#undef DECODE_ARGS
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* ck, const void* cv,
                   const int* cpos, const void* k1, const void* v1,
                   const int* pos, void* out, int B, int H, int Hkv, int Dh,
                   int Sc, int window, float softcap, cudaStream_t st) {
  switch (Dh) {
    case 32: return launch_g<T, 1>(q, ck, cv, cpos, k1, v1, pos, out, B, H,
                                   Hkv, Sc, window, softcap, st);
    case 64: return launch_g<T, 2>(q, ck, cv, cpos, k1, v1, pos, out, B, H,
                                   Hkv, Sc, window, softcap, st);
    case 128: return launch_g<T, 4>(q, ck, cv, cpos, k1, v1, pos, out, B, H,
                                    Hkv, Sc, window, softcap, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,H,Dh]; ck/cv [B,Sc,Hkv,Dh]; cpos [B,Sc] int32; k1/v1 [B,Hkv,Dh];
// pos [B] int32 -> out [B,H,Dh]; all contiguous. G = H / Hkv in
// {1, 2, 4, 8}, Dh in {32, 64, 128}. dtype 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after the launch.
extern "C" int decode_attention_fused(const void* q, const void* ck,
                                      const void* cv, const void* cpos,
                                      const void* k1, const void* v1,
                                      const void* pos, void* out, int B,
                                      int H, int Hkv, int Dh, int Sc,
                                      int window, float softcap, int dtype,
                                      void* stream) {
  if (Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(q, ck, cv, (const int*)cpos, k1, v1,
                        (const int*)pos, out, B, H, Hkv, Dh, Sc, window,
                        softcap, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(q, ck, cv, (const int*)cpos, k1, v1,
                                (const int*)pos, out, B, H, Hkv, Dh, Sc,
                                window, softcap, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
