// GQA decode attention for Hopper (sm_90a): one kernel body, two layouts.
//
// Replaces two TPU kernels of src/repro/kernels/decode_attention.py:
//   * decode_attention_fused (_decode_attn_fused_kernel): a contiguous
//     cache [B, Sc, Hkv, Dh];
//   * decode_attention_paged (_decode_attn_paged_kernel): page pools
//     [P, pt, Hkv, Dh] read through a block table bt [B, nblk] (page 0 is
//     the null page, its positions -1 forever).
// Both: one query token per row against its cached K/V (mask cpos >= 0 &
// cpos <= pos, optional sliding window on the contiguous layout, tanh
// softcap), the current token's (k1, v1) folded in at the end, then
// normalised. Accumulation is float32.
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
// loads; a head dimension that is not a multiple of 32, such as Zamba2's
// 112, leaves the last group's upper lanes holding zeros, which add
// nothing to any sum), the 4 * G scores of a group are warp-wide reductions interleaved
// for instruction-level parallelism, and the warp's online softmax (m, l,
// acc) takes one rescale per group. A masked position contributes exactly
// nothing (probability 0, max unchanged), as in the block update. The
// warps' partials merge through shared memory, and the epilogue folds
// (k1, v1) and normalises. The TPU kernel's sequential kv-block grid axis
// becomes the loop inside the block; nothing crosses blocks.
//
// The layout is a template parameter that only says where logical cache
// position j of row b lives: row b * Sc + j of the contiguous cache, or
// row bt[b, j / pt] * pt + j % pt of the page pool (Sc = nblk * pt). The
// warps visit the same logical positions in the same order and do the
// same arithmetic in both, so the paged kernel is bitwise equal to the
// contiguous one on the same logical content (the property the TPU kernel
// states at block_k == page_tokens). Each block reads its own block-table
// row, which replaces the TPU kernel's scalar prefetch: with pt a multiple
// of NJ a group of positions never straddles a page, so the indirection
// costs one dependent load per group of NJ positions.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int NWARPS = 8;
constexpr int NJ = 4;                       // cache positions per warp step

// Row of the K/V arrays (and index into the positions) holding logical
// position j0 of batch row b; positions j0 .. j0 + NJ - 1 (j0 a multiple
// of NJ) are the consecutive rows after it.
struct Contiguous {
  int Sc;
  __device__ __forceinline__ size_t group(int b, int j0) const {
    return (size_t)b * Sc + j0;
  }
};

struct Paged {
  const int* bt;                            // [B, nblk]
  int nblk, pt;                             // pt % NJ == 0
  __device__ __forceinline__ size_t group(int b, int j0) const {
    const int page = __ldg(&bt[(size_t)b * nblk + j0 / pt]);
    return (size_t)page * pt + j0 % pt;
  }
};

template <typename T, int DH, int G, typename Layout>
__global__ void __launch_bounds__(NWARPS * 32)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ ck,
                   const T* __restrict__ cv, const int* __restrict__ cpos,
                   const T* __restrict__ k1, const T* __restrict__ v1,
                   const int* __restrict__ pos, T* __restrict__ out, int H,
                   int Hkv, int Sc, int window, float softcap, float scale,
                   Layout layout) {
  constexpr int EPL = (DH + 31) / 32;       // head elements per lane
  constexpr int DP = EPL * 32;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p = pos[b];
  // whether lane element e lies inside the head (always, when DH % 32 == 0)
  auto in = [lane](int e) { return DH % 32 == 0 || lane + 32 * e < DH; };

  float qr[G][EPL];
  float acc[G][EPL];
  float m[G];
  float l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
    const size_t off = ((size_t)b * H + (size_t)hk * G + g) * DH + lane;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      acc[g][e] = 0.f;
      qr[g][e] = in(e) ? to_f(q[off + 32 * e]) * scale : 0.f;
    }
  }

  const size_t stride = (size_t)Hkv * DH;   // between cache rows
  const size_t head = (size_t)hk * DH + lane;
  for (int j0 = warp * NJ; j0 < Sc; j0 += NWARPS * NJ) {
    const size_t r0 = layout.group(b, j0);
    bool valid[NJ];
    float kr[NJ][EPL], vr[NJ][EPL];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int cp = j0 + jj < Sc ? cpos[r0 + jj] : -1;
      valid[jj] = cp >= 0 && cp <= p && (!window || cp > p - window);
      const size_t off = (r0 + jj) * stride + head;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        kr[jj][e] = valid[jj] && in(e) ? to_f(ck[off + 32 * e]) : 0.f;
        vr[jj][e] = valid[jj] && in(e) ? to_f(cv[off + 32 * e]) : 0.f;
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
  __shared__ float sm_acc[NWARPS][G][DP];
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
    const size_t qoff = ((size_t)b * H + (size_t)hk * G + g) * DH + lane;
    const size_t koff = ((size_t)b * Hkv + hk) * DH + lane;
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      if (in(e))
        s += to_f(q[qoff + 32 * e]) * scale * to_f(k1[koff + 32 * e]);
    s = warp_sum(s);
    if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
    const float m_f = fmaxf(mm, s);
    const float corr = expf(mm - m_f);
    const float ps = expf(s - m_f);
    const float denom = fmaxf(ll * corr + ps, 1e-30f);
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      if (!in(e)) continue;
      const float o = (a[e] * corr + ps * to_f(v1[koff + 32 * e])) / denom;
      store(&out[qoff + 32 * e], o);
    }
  }
}

template <typename T, int DH, typename Layout>
cudaError_t launch_g(const void* q, const void* ck, const void* cv,
                     const int* cpos, const void* k1, const void* v1,
                     const int* pos, void* out, int B, int H, int Hkv,
                     int Sc, int window, float softcap, Layout layout,
                     cudaStream_t st) {
  const float scale = 1.0f / sqrtf((float)DH);
  const dim3 grid(Hkv, B);
  const dim3 block(NWARPS * 32);
#define DECODE_ARGS                                                        \
  (const T*)q, (const T*)ck, (const T*)cv, cpos, (const T*)k1,             \
      (const T*)v1, pos, (T*)out, H, Hkv, Sc, window, softcap, scale, layout
  switch (H / Hkv) {
    case 1: decode_attn_kernel<T, DH, 1, Layout><<<grid, block, 0, st>>>(DECODE_ARGS); break;
    case 2: decode_attn_kernel<T, DH, 2, Layout><<<grid, block, 0, st>>>(DECODE_ARGS); break;
    case 4: decode_attn_kernel<T, DH, 4, Layout><<<grid, block, 0, st>>>(DECODE_ARGS); break;
    case 8: decode_attn_kernel<T, DH, 8, Layout><<<grid, block, 0, st>>>(DECODE_ARGS); break;
    default: return cudaErrorInvalidValue;
  }
#undef DECODE_ARGS
  return cudaGetLastError();
}

template <typename T, typename Layout>
cudaError_t launch(const void* q, const void* ck, const void* cv,
                   const int* cpos, const void* k1, const void* v1,
                   const int* pos, void* out, int B, int H, int Hkv, int Dh,
                   int Sc, int window, float softcap, Layout layout,
                   cudaStream_t st) {
  switch (Dh) {
    case 32: return launch_g<T, 32>(q, ck, cv, cpos, k1, v1, pos, out, B, H,
                                   Hkv, Sc, window, softcap, layout, st);
    case 64: return launch_g<T, 64>(q, ck, cv, cpos, k1, v1, pos, out, B, H,
                                   Hkv, Sc, window, softcap, layout, st);
    case 112: return launch_g<T, 112>(q, ck, cv, cpos, k1, v1, pos, out, B,
                                      H, Hkv, Sc, window, softcap, layout,
                                      st);
    case 128: return launch_g<T, 128>(q, ck, cv, cpos, k1, v1, pos, out, B,
                                      H, Hkv, Sc, window, softcap, layout,
                                      st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename Layout>
int launch_dtype(const void* q, const void* ck, const void* cv,
                 const void* cpos, const void* k1, const void* v1,
                 const void* pos, void* out, int B, int H, int Hkv, int Dh,
                 int Sc, int window, float softcap, int dtype, Layout layout,
                 void* stream) {
  if (Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(q, ck, cv, (const int*)cpos, k1, v1, (const int*)pos,
                        out, B, H, Hkv, Dh, Sc, window, softcap, layout, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(q, ck, cv, (const int*)cpos, k1, v1,
                                (const int*)pos, out, B, H, Hkv, Dh, Sc,
                                window, softcap, layout, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

}  // namespace

// q [B,H,Dh]; ck/cv [B,Sc,Hkv,Dh]; cpos [B,Sc] int32; k1/v1 [B,Hkv,Dh];
// pos [B] int32 -> out [B,H,Dh]; all contiguous. G = H / Hkv in
// {1, 2, 4, 8}, Dh in {32, 64, 112, 128}. dtype 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after the launch.
extern "C" int decode_attention_fused(const void* q, const void* ck,
                                      const void* cv, const void* cpos,
                                      const void* k1, const void* v1,
                                      const void* pos, void* out, int B,
                                      int H, int Hkv, int Dh, int Sc,
                                      int window, float softcap, int dtype,
                                      void* stream) {
  return launch_dtype(q, ck, cv, cpos, k1, v1, pos, out, B, H, Hkv, Dh, Sc,
                      window, softcap, dtype, Contiguous{Sc}, stream);
}

// q [B,H,Dh]; pk/pv [P,pt,Hkv,Dh] page pools; ppos [P,pt] int32; bt
// [B,nblk] int32 with entries in [0, P); k1/v1 [B,Hkv,Dh]; pos [B] int32
// -> out [B,H,Dh]; all contiguous. pt a multiple of 4; no window. Same
// G, Dh and dtype codes as decode_attention_fused.
extern "C" int decode_attention_paged(const void* q, const void* pk,
                                      const void* pv, const void* ppos,
                                      const void* bt, const void* k1,
                                      const void* v1, const void* pos,
                                      void* out, int B, int H, int Hkv,
                                      int Dh, int pt, int nblk,
                                      float softcap, int dtype,
                                      void* stream) {
  if (pt <= 0 || pt % NJ != 0) return (int)cudaErrorInvalidValue;
  return launch_dtype(q, pk, pv, ppos, k1, v1, pos, out, B, H, Hkv, Dh,
                      nblk * pt, 0, softcap, dtype,
                      Paged{(const int*)bt, nblk, pt}, stream);
}
