// GQA decode attention for Hopper (sm_90a): one kernel body, two cache
// layouts and two ways to finish.
//
// Replaces three TPU kernels of src/repro/kernels/decode_attention.py:
//   * decode_attention_fused (_decode_attn_fused_kernel): a contiguous
//     cache [B, Sc, Hkv, Dh];
//   * decode_attention_paged (_decode_attn_paged_kernel): page pools
//     [P, pt, Hkv, Dh] read through a block table bt [B, nblk] (page 0 is
//     the null page, its positions -1 forever);
//   * decode_attention_partial (_decode_attn_kernel): the contiguous
//     cache's online-softmax partials (m, l, acc) in float32, for a
//     caller that combines them outside the kernel (a cache split along
//     Sc, merged in log-sum-exp form).
// All: one query token per row against its cached K/V (mask cpos >= 0 &
// cpos <= pos, optional sliding window on the contiguous layout, tanh
// softcap), scale 1/sqrt(Dh) applied inside. The fused and paged kernels
// then fold the current token's (k1, v1) in and normalise; the partial
// kernel writes the partials as they are. Accumulation is float32.
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
// 112 or Danube's 80, leaves the last group's upper lanes holding zeros,
// which add nothing to any sum), the 4 * G scores of a group are warp-wide
// reductions interleaved for instruction-level parallelism, and the warp's
// online softmax (m, l, acc) takes one rescale per group. A masked
// position contributes exactly nothing (probability 0, max unchanged), as
// in the block update. The warps' partials merge through shared memory,
// and the epilogue (the Out parameter) finishes each query head. The TPU
// kernel's sequential kv-block grid axis becomes the loop inside the
// block; nothing crosses blocks. block_k is TPU tiling and is dropped.
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
//
// A row with no valid key finishes with m = -1e30, l = 0, acc = 0 in the
// partial kernel (the plain version's values; the TPU kernel leaves l =
// Sc there, since its masked scores contribute exp(0) while m is still
// -1e30). The combine sends both to the same output.
//
// (Dh, G) built: one table, `built` below, which the C entry
// decode_attention_supports hands to the Python wrappers. The fused and
// paged kernels: Dh in {32, 64, 112, 128} at G in {1, 2, 4, 8} (the pairs
// built before Dh 80 and 256 came in), plus (80, 4) for H2O-Danube-1.8B,
// (128, 6) for Qwen2-1.5B and (256, 2) for Gemma2-2B. The partial kernel:
// those three new pairs only, where it is called. At Dh 256 the merge
// array sm_acc[8][G][Dh] of float32 takes 16 KB at G 2 (48 KB static
// limit).
#include "common.cuh"

namespace {

using namespace repro;

constexpr int NWARPS = 8;
constexpr int NJ = 4;                       // cache positions per warp step

constexpr bool fused_ok(int dh, int g) {
  return ((dh == 32 || dh == 64 || dh == 112 || dh == 128) &&
          (g == 1 || g == 2 || g == 4 || g == 8)) ||
         (dh == 80 && g == 4) || (dh == 128 && g == 6) ||
         (dh == 256 && g == 2);
}

constexpr bool partial_ok(int dh, int g) {
  return (dh == 80 && g == 4) || (dh == 128 && g == 6) ||
         (dh == 256 && g == 2);
}

// whether (Dh, G) is built for the epilogue Out (Out::kPartial)
template <typename Out>
constexpr bool built(int dh, int g) {
  return Out::kPartial ? partial_ok(dh, g) : fused_ok(dh, g);
}

// whether lane element e lies inside the head (always, when DH % 32 == 0)
template <int DH>
__device__ __forceinline__ bool lane_in(int lane, int e) {
  return DH % 32 == 0 || lane + 32 * e < DH;
}

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

// How a block finishes query head r = b * H + hk * G + g from its merged
// partials (mm, ll, a): lane owns elements lane + 32 e of the head.
template <typename T>
struct Fused {                              // fold (k1, v1), normalise
  static constexpr bool kPartial = false;
  const T* k1;                              // [B, Hkv, Dh]
  const T* v1;
  T* out;                                   // [B, H, Dh]
  template <int DH, int EPL>
  __device__ __forceinline__ void finish(const T* q, size_t r, size_t kvrow,
                                         int lane, float scale,
                                         float softcap, float mm, float ll,
                                         const float (&a)[EPL]) const {
    const size_t qoff = r * DH + lane;
    const size_t koff = kvrow * DH + lane;
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      if (lane_in<DH>(lane, e))
        s += to_f(q[qoff + 32 * e]) * scale * to_f(k1[koff + 32 * e]);
    s = warp_sum(s);
    if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
    const float m_f = fmaxf(mm, s);
    const float corr = expf(mm - m_f);
    const float ps = expf(s - m_f);
    const float denom = fmaxf(ll * corr + ps, 1e-30f);
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      if (!lane_in<DH>(lane, e)) continue;
      const float o = (a[e] * corr + ps * to_f(v1[koff + 32 * e])) / denom;
      store(&out[qoff + 32 * e], o);
    }
  }
};

struct Partial {                            // the partials, as they are
  static constexpr bool kPartial = true;
  float* m;                                 // [B, Hkv, G] = [B * H]
  float* l;
  float* acc;                               // [B, Hkv, G, Dh] = [B * H, Dh]
  template <int DH, int EPL, typename T>
  __device__ __forceinline__ void finish(const T*, size_t r, size_t, int lane,
                                         float, float, float mm, float ll,
                                         const float (&a)[EPL]) const {
    if (lane == 0) {
      m[r] = mm;
      l[r] = ll;
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      if (lane_in<DH>(lane, e)) acc[r * DH + lane + 32 * e] = a[e];
  }
};

template <typename T, int DH, int G, typename Layout, typename Out>
__global__ void __launch_bounds__(NWARPS * 32)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ ck,
                   const T* __restrict__ cv, const int* __restrict__ cpos,
                   const int* __restrict__ pos, int H, int Hkv, int Sc,
                   int window, float softcap, float scale, Layout layout,
                   Out fin) {
  constexpr int EPL = (DH + 31) / 32;       // head elements per lane
  constexpr int DP = EPL * 32;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p = pos[b];
  auto in = [lane](int e) { return lane_in<DH>(lane, e); };

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

  // epilogue: merge the warps' partials, then finish each query head
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
    fin.template finish<DH, EPL>(q, (size_t)b * H + (size_t)hk * G + g,
                                 (size_t)b * Hkv + hk, lane, scale, softcap,
                                 mm, ll, a);
  }
}

template <typename T, int DH, int G, typename Layout, typename Out>
cudaError_t launch_dg(const T* q, const T* ck, const T* cv, const int* cpos,
                      const int* pos, int B, int H, int Hkv, int Sc,
                      int window, float softcap, Layout layout, Out fin,
                      cudaStream_t st) {
  if constexpr (!built<Out>(DH, G)) {
    return cudaErrorInvalidValue;
  } else {
    const float scale = 1.0f / sqrtf((float)DH);
    decode_attn_kernel<T, DH, G, Layout, Out>
        <<<dim3(Hkv, B), dim3(NWARPS * 32), 0, st>>>(
            q, ck, cv, cpos, pos, H, Hkv, Sc, window, softcap, scale, layout,
            fin);
    return cudaGetLastError();
  }
}

template <typename T, int DH, typename Layout, typename Out>
cudaError_t launch_d(const T* q, const T* ck, const T* cv, const int* cpos,
                     const int* pos, int B, int H, int Hkv, int Sc,
                     int window, float softcap, Layout layout, Out fin,
                     cudaStream_t st) {
#define DECODE_G(G)                                                        \
  case G:                                                                  \
    return launch_dg<T, DH, G>(q, ck, cv, cpos, pos, B, H, Hkv, Sc, window, \
                               softcap, layout, fin, st)
  switch (H / Hkv) {
    DECODE_G(1);
    DECODE_G(2);
    DECODE_G(4);
    DECODE_G(6);
    DECODE_G(8);
    default: return cudaErrorInvalidValue;
  }
#undef DECODE_G
}

template <typename T, typename Layout, typename Out>
int launch(const void* q, const void* ck, const void* cv, const void* cpos,
           const void* pos, int B, int H, int Hkv, int Dh, int Sc,
           int window, float softcap, Layout layout, Out fin, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DECODE_D(DH)                                                       \
  case DH:                                                                 \
    return (int)launch_d<T, DH>((const T*)q, (const T*)ck, (const T*)cv,   \
                                (const int*)cpos, (const int*)pos, B, H,   \
                                Hkv, Sc, window, softcap, layout, fin, st)
  switch (Dh) {
    DECODE_D(32);
    DECODE_D(64);
    DECODE_D(80);
    DECODE_D(112);
    DECODE_D(128);
    DECODE_D(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DECODE_D
}

// Calls f with a value of the element type that ``dtype`` names (0 =
// float32, 1 = bfloat16).
template <typename F>
int by_dtype(int dtype, F&& f) {
  if (dtype == 0) return f(float{});
  if (dtype == 1) return f(__nv_bfloat16{});
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [B,H,Dh]; ck/cv [B,Sc,Hkv,Dh]; cpos [B,Sc] int32; k1/v1 [B,Hkv,Dh];
// pos [B] int32 -> out [B,H,Dh]; all contiguous. (Dh, G = H / Hkv) as
// decode_attention_supports says. dtype 0 = float32, 1 = bfloat16. Returns
// cudaGetLastError() after the launch.
extern "C" int decode_attention_fused(const void* q, const void* ck,
                                      const void* cv, const void* cpos,
                                      const void* k1, const void* v1,
                                      const void* pos, void* out, int B,
                                      int H, int Hkv, int Dh, int Sc,
                                      int window, float softcap, int dtype,
                                      void* stream) {
  return by_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    return launch<T>(q, ck, cv, cpos, pos, B, H, Hkv, Dh, Sc, window,
                     softcap, Contiguous{Sc},
                     Fused<T>{(const T*)k1, (const T*)v1, (T*)out}, stream);
  });
}

// q [B,H,Dh]; pk/pv [P,pt,Hkv,Dh] page pools; ppos [P,pt] int32; bt
// [B,nblk] int32 with entries in [0, P); k1/v1 [B,Hkv,Dh]; pos [B] int32
// -> out [B,H,Dh]; all contiguous. pt a multiple of 4; no window. Same
// (Dh, G) and dtype codes as decode_attention_fused.
extern "C" int decode_attention_paged(const void* q, const void* pk,
                                      const void* pv, const void* ppos,
                                      const void* bt, const void* k1,
                                      const void* v1, const void* pos,
                                      void* out, int B, int H, int Hkv,
                                      int Dh, int pt, int nblk,
                                      float softcap, int dtype,
                                      void* stream) {
  if (pt <= 0 || pt % NJ != 0) return (int)cudaErrorInvalidValue;
  return by_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    return launch<T>(q, pk, pv, ppos, pos, B, H, Hkv, Dh, nblk * pt, 0,
                     softcap, Paged{(const int*)bt, nblk, pt},
                     Fused<T>{(const T*)k1, (const T*)v1, (T*)out}, stream);
  });
}

// q [B,H,Dh] (unscaled); ck/cv [B,Sc,Hkv,Dh]; cpos [B,Sc] int32; pos [B]
// int32 -> m, l [B,Hkv,G] and acc [B,Hkv,G,Dh], float32, contiguous. (Dh,
// G) as decode_attention_supports says; dtype codes (of q and the cache) as
// decode_attention_fused.
extern "C" int decode_attention_partial(const void* q, const void* ck,
                                        const void* cv, const void* cpos,
                                        const void* pos, void* m, void* l,
                                        void* acc, int B, int H, int Hkv,
                                        int Dh, int Sc, int window,
                                        float softcap, int dtype,
                                        void* stream) {
  return by_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    return launch<T>(q, ck, cv, cpos, pos, B, H, Hkv, Dh, Sc, window,
                     softcap, Contiguous{Sc},
                     Partial{(float*)m, (float*)l, (float*)acc}, stream);
  });
}

// 1 if the kernels are built for head dim dh at group size g = H / Hkv:
// the fused and paged kernels (partial 0) or the partial kernel (partial
// 1); else 0. Launches nothing.
extern "C" int decode_attention_supports(int dh, int g, int partial) {
  return partial ? partial_ok(dh, g) : fused_ok(dh, g);
}
