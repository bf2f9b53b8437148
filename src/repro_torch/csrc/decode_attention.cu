// GQA decode attention for Hopper (sm_90a): two kernel bodies, two cache
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
// cache slice once (2 * Dh values per position) and does ~G flops per
// byte read (G = 1-48 query heads per kv-head), far below the ~295
// flops/byte where the tensor cores would matter: they are not the lever,
// and neither body uses them. What keeps a kernel from the byte bound is
// latency: too few blocks, or too few bytes in flight per SM.
//
// Two bodies share the layouts and the epilogues:
//
// * The split body (bfloat16 fused, paged and partial, the serving paths):
//   flash-decoding. The grid is (split, kv-head, row); split s reduces the
//   fixed logical positions [s * SPLIT, (s + 1) * SPLIT) of its row to
//   float32 partials (m, l, acc) for the G query heads of its kv-head, and
//   the last block of a (kv-head, row) to finish (an atomic ticket in a
//   counter of the call's scratch, zeroed on the stream by the launch)
//   merges the splits' partials in split
//   order from split 0 up (all its threads, a float4 of acc each). Its
//   epilogue (the Out parameter) then either folds (k1, v1) in and
//   normalises with Fused::finish's arithmetic (finish_row), q, k1 and v1
//   read from shared memory, or writes the merged partials as they are
//   (Partial: the block stages q only). One launch a
//   call, no host sync, scratch sized by the shapes alone. A block first
//   reads its split's positions (and, paged, block-table rows) and skips
//   every tile of TJ positions with no valid key without loading it; a
//   split with none writes m = NEG_INF only and the merge skips it, so it
//   is an exact no-op. The valid tiles stream through a ring of 2-4
//   shared-memory stages that 16-byte cp.async copies fill, every stage
//   before the first wait (masked positions zero-filled, not read).
//   Scores: the lanes of a position (NSEG = 128 / TJ adjacent lanes) take
//   16-byte chunks of its key row in turn and meet in a fixed butterfly,
//   so head dims 80 and 112 waste no lane; q comes from shared memory as a
//   broadcast. A tile's max over its valid scores moves every head's
//   running max once; each p = exp(s - m) is computed once, by its
//   position's lanes. P V: thread (r, c) owns 16-byte chunk c of every
//   head for the positions r, r + R, ... of each tile (R = 128 / (Dh /
//   8)), and the R sums meet in order at the split's end.
//   SPLIT = 128 and a ring of at most 48 KB: of the splits 128, 256 and
//   512 and rings of 32-64 KB, the fastest summed over the served decode
//   shapes on an H100 (PERF.md); longer splits were faster only on the
//   4096-token rings, whose grids then fit in one wave. What the split
//   body still loses to the byte bound there is per-block latency: the
//   positions' round trip, the first tiles' wait while every block loads
//   at once, the ticket's fence and the merge.
//   Row invariance: tiles, splits and every sum follow logical positions
//   from index 0 and skip exactly the tiles and splits without a valid key,
//   so a row's bits depend on its own cache content and pos only: not on
//   B, the other rows, Sc or the layout. Paged == contiguous, failover ==
//   failure-free and chunked == whole-prompt rest on it. The partial
//   kernel's (m, l, acc) are the floats the fused kernel folds (k1, v1)
//   into: the two epilogues share everything before them.
// * The warp body (float32 fused, paged and partial; the first design,
//   kept for its bits): one block per (kv-head,
//   row). Eight warps take groups of NJ = 4 consecutive cache positions
//   round-robin; inside a warp the 32 lanes split the head dimension (lane
//   l owns elements l, l+32, ...; a head dimension that is not a multiple
//   of 32 leaves the last group's upper lanes holding zeros), the 4 * G
//   scores of a group are warp-wide reductions interleaved for
//   instruction-level parallelism, and the warp's online softmax (m, l,
//   acc) takes one rescale per group. A group with no valid key is
//   skipped. The warps' partials merge through shared memory, and the
//   epilogue (the Out parameter) finishes each query head.
// In both, a masked position contributes exactly nothing (probability 0,
// max unchanged), and the TPU kernel's block_k (TPU tiling) is dropped.
//
// Head groups: a block takes at most 8 query heads (the per-head state of
// both bodies, l[G] and acc[G][8] in registers, the warp body's sm_acc
// [NWARPS][G][Dh] in static shared memory, is sized by them). A kv-head
// with G > 8 query heads (Granite-34B's MQA: 48 on one) is split into NG
// = G / 8 head groups, one more block index each (the kv-head index of
// the grid becomes the head-group index hg, kv-head hg / NG): each group
// runs the G-8 body on its 8 heads and reads the kv-head's K/V itself,
// and each has its own partials and merge ticket. A head's running max,
// sums and order of sums depend only on its own q, so a G-48 call gives
// bitwise the outputs of six G-8 calls on the six head slices; at G <= 8,
// NG = 1 and the code is the code before head groups. Reading the K/V
// once a group costs up to NG times the cache bytes from L2 or memory.
//
// The layout is a template parameter that only says where logical cache
// position j of row b lives: row b * Sc + j of the contiguous cache, or
// row bt[b, j / pt] * pt + j % pt of the page pool (Sc = nblk * pt). Both
// bodies visit the same logical positions in the same order and do the
// same arithmetic in both, so each paged kernel is bitwise equal to its
// contiguous one on the same logical content (the property the TPU kernel
// states at block_k == page_tokens). Each block reads its own block-table
// row, which replaces the TPU kernel's scalar prefetch.
//
// A row with no valid key finishes with m = -1e30, l = 0, acc = 0 in the
// partial kernel (the plain version's values; the TPU kernel leaves l =
// Sc there, since its masked scores contribute exp(0) while m is still
// -1e30): in the split body every split of such a row is NEG_INF, so the
// merge keeps mm = NEG_INF and adds nothing. The combine sends both to
// the same output.
//
// (Dh, G) built: one table, `built` below, which the C entry
// decode_attention_supports hands to the Python wrappers. The fused and
// paged kernels: Dh in {32, 64, 112, 128} at G in {1, 2, 4, 8} (the pairs
// built before Dh 80 and 256 came in; (128, 1) serves Qwen1.5-MoE-A2.7B,
// (112, 8) Kimi-K2, (128, 8) Chameleon-34B), plus (80, 4) for
// H2O-Danube-1.8B, (128, 6) for Qwen2-1.5B, (256, 2) for Gemma2-2B and
// (128, 48) for Granite-34B (six head groups of 8). The partial kernel:
// those three new pairs and Mixtral-8x7B's (128, 4). At Dh 256 the warp
// body's merge array sm_acc[8][G][Dh] of float32 takes 16 KB at G 2 (48
// KB static limit); the split body takes dynamic shared memory.
#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace repro;

constexpr int NWARPS = 8;
constexpr int NJ = 4;                       // cache positions per warp step

constexpr bool fused_ok(int dh, int g) {
  return ((dh == 32 || dh == 64 || dh == 112 || dh == 128) &&
          (g == 1 || g == 2 || g == 4 || g == 8)) ||
         (dh == 80 && g == 4) || (dh == 128 && g == 6) ||
         (dh == 256 && g == 2) || (dh == 128 && g == 48);
}

constexpr bool partial_ok(int dh, int g) {
  return (dh == 80 && g == 4) || (dh == 128 && g == 4) ||
         (dh == 128 && g == 6) || (dh == 256 && g == 2);
}

// whether (Dh, G) is built for the epilogue Out (Out::kPartial)
template <typename Out>
constexpr bool built(int dh, int g) {
  return Out::kPartial ? partial_ok(dh, g) : fused_ok(dh, g);
}

// query heads a block takes at group size g, and head groups a kv-head
constexpr int group_heads(int g) { return g > 8 ? 8 : g; }
constexpr int head_groups(int g) { return g / group_heads(g); }

// The one place a call's (Dh, G) becomes template arguments: returns f(dh,
// g) with dh and g as std::integral_constant, where Dh is in {32, 64, 80,
// 112, 128, 256} and G in {1, 2, 4, 6, 8, 48}; else cudaErrorInvalidValue. f
// itself refuses the pairs its body is not built for.
template <int DH, typename F>
int by_g(int g, F& f) {
  using D = std::integral_constant<int, DH>;
  switch (g) {
    case 1: return f(D{}, std::integral_constant<int, 1>{});
    case 2: return f(D{}, std::integral_constant<int, 2>{});
    case 4: return f(D{}, std::integral_constant<int, 4>{});
    case 6: return f(D{}, std::integral_constant<int, 6>{});
    case 8: return f(D{}, std::integral_constant<int, 8>{});
    case 48: return f(D{}, std::integral_constant<int, 48>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename F>
int by_dh_g(int dh, int g, F&& f) {
  switch (dh) {
    case 32: return by_g<32>(g, f);
    case 64: return by_g<64>(g, f);
    case 80: return by_g<80>(g, f);
    case 112: return by_g<112>(g, f);
    case 128: return by_g<128>(g, f);
    case 256: return by_g<256>(g, f);
    default: return (int)cudaErrorInvalidValue;
  }
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

// Fold the current token (k1, v1) into a query head's merged partials
// (mm, ll, a) and normalise into out: one warp, lane owning elements
// lane + 32 e of the head (q, k1, v1 and out point at the head's rows,
// in global or shared memory).
template <int DH, int EPL, typename T>
__device__ __forceinline__ void finish_row(const T* q, const T* k1,
                                           const T* v1, T* out, int lane,
                                           float scale, float softcap,
                                           float mm, float ll,
                                           const float (&a)[EPL]) {
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < EPL; ++e)
    if (lane_in<DH>(lane, e))
      s += to_f(q[lane + 32 * e]) * scale * to_f(k1[lane + 32 * e]);
  s = warp_sum(s);
  if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
  const float m_f = fmaxf(mm, s);
  const float corr = expf(mm - m_f);
  const float ps = expf(s - m_f);
  const float denom = fmaxf(ll * corr + ps, 1e-30f);
#pragma unroll
  for (int e = 0; e < EPL; ++e) {
    if (!lane_in<DH>(lane, e)) continue;
    const float o = (a[e] * corr + ps * to_f(v1[lane + 32 * e])) / denom;
    store(&out[lane + 32 * e], o);
  }
}

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
    finish_row<DH, EPL>(q + r * DH, k1 + kvrow * DH, v1 + kvrow * DH,
                        out + r * DH, lane, scale, softcap, mm, ll, a);
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

// G: query heads of the block's head group; NG: head groups a kv-head
template <typename T, int DH, int G, int NG, typename Layout, typename Out>
__global__ void __launch_bounds__(NWARPS * 32)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ ck,
                   const T* __restrict__ cv, const int* __restrict__ cpos,
                   const int* __restrict__ pos, int H, int Hkv, int Sc,
                   int window, float softcap, float scale, Layout layout,
                   Out fin) {
  constexpr int EPL = (DH + 31) / 32;       // head elements per lane
  constexpr int DP = EPL * 32;
  const int hg = blockIdx.x;                // head group
  const int hk = hg / NG;                   // its kv-head
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
    const size_t off = ((size_t)b * H + (size_t)hg * G + g) * DH + lane;
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
    fin.template finish<DH, EPL>(q, (size_t)b * H + (size_t)hg * G + g,
                                 (size_t)b * Hkv + hk, lane, scale, softcap,
                                 mm, ll, a);
  }
}

// --------------------------------------------------------------------------
// The split body (bfloat16 fused, paged and partial)
// --------------------------------------------------------------------------

namespace split {

using bf16 = __nv_bfloat16;

constexpr int NT = 128;                     // threads a block
constexpr int NW = NT / 32;
constexpr int SPLIT = 128;                  // cache positions a block

// shared-memory bytes of one cached row: at least Dh * 2, and with the
// NSEG lanes of a position reading 16 * NSEG bytes of its row at a time,
// the 8 / NSEG rows that one 8-lane phase of a 16-byte load reads fall on
// disjoint banks (row bytes an odd multiple of 16 * NSEG)
constexpr int row_bytes(int dh, int nseg) {
  if (nseg >= 8) return dh * 2;
  const int unit = 16 * nseg;
  const int u = (dh * 2 + unit - 1) / unit;
  return (u % 2 ? u : u + 1) * unit;
}

constexpr int clamp(int x, int lo, int hi) {
  return x < lo ? lo : x > hi ? hi : x;
}

template <int DH, int G>
struct Cfg {
  static constexpr int NCH = DH / 8;                  // 16-byte chunks a row
  static constexpr int TJ = DH <= 112 ? 64 : DH <= 128 ? 32 : 16;
  static constexpr int NSEG = NT / TJ;                // lanes a position
  static constexpr int ROWB = row_bytes(DH, NSEG);
  static constexpr int TILE = TJ * ROWB;              // K (or V) of a tile
  static constexpr int STAGE = 2 * TILE;
  static constexpr int STAGES = clamp(49152 / STAGE, 2, 4);
  static constexpr int NTILES = SPLIT / TJ;
  static constexpr int R = NT / NCH;                  // P V position groups
  static constexpr int GW = (G + NW - 1) / NW;        // heads a warp merges
  static constexpr int EPL = (DH + 31) / 32;
  // the ring, then (the same bytes) the position groups' sums, then the
  // merge's weights and sums
  static constexpr int RED = R * G * DH * 4 + R * G * 4;
  static constexpr int RING = STAGES * STAGE > RED ? STAGES * STAGE : RED;
  static constexpr int OFF_Q = RING;                  // q: G x Dh bf16
  static constexpr int OFF_KV1 = OFF_Q + G * DH * 2;  // k1, v1: Dh bf16
  static constexpr int OFF_P = OFF_KV1 + 2 * DH * 2;  // p: TJ x G float
  static constexpr int OFF_WMAX = OFF_P + TJ * G * 4; // NW x G float
  static constexpr int OFF_ROW = OFF_WMAX + NW * G * 4;  // SPLIT int
  static constexpr int OFF_OK = OFF_ROW + SPLIT * 4;  // SPLIT bytes
  static constexpr int OFF_MISC = OFF_OK + SPLIT;     // tile mask, ticket
  static constexpr int BYTES = OFF_MISC + 16;
  static_assert(DH % 16 == 0 && NCH % NSEG == 0, "head dim");
  static_assert(NT % TJ == 0 && SPLIT % TJ == 0 && SPLIT % NT == 0 &&
                NTILES <= 32, "tiles");
  static_assert(R >= 1 && (32 * G + G * DH) * 4 <= RING,
                "position groups; the merge's weights and sums");
};

// the eight floats of a 16-byte chunk of bf16
__device__ __forceinline__ void unpack8(const uint4 w, float (&f)[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// Scratch of a call, per head group (G its query heads, NG groups a
// kv-head): acc [B, Hkv * NG, nsplit, G, Dh] then (m, l) [B, Hkv * NG,
// nsplit, 2, G], float32, then the ticket counters [B, Hkv * NG], int32.
__host__ __device__ inline size_t acc_floats(int B, int Hkv, int nsplit,
                                             int G, int DH) {
  return (size_t)B * Hkv * nsplit * G * DH;
}

// Out: Fused<bf16> (fold (k1, v1), normalise) or Partial (the merged
// partials as they are). G: query heads of the block's head group; NG:
// head groups a kv-head (the grid's y index is the head group).
template <int DH, int G, int NG, typename Layout, typename Out>
__global__ void __launch_bounds__(NT)
decode_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ ck,
                    const bf16* __restrict__ cv, const int* __restrict__ cpos,
                    const int* __restrict__ pos, int H, int Hkv, int Sc,
                    int window, float softcap, float scale, Layout layout,
                    Out fin, float* __restrict__ ws,
                    int* __restrict__ tickets) {
  using C = Cfg<DH, G>;
  extern __shared__ __align__(128) char smem[];
  const int split = blockIdx.x, hg = blockIdx.y, b = blockIdx.z;
  const int hk = hg / NG;                   // the head group's kv-head
  const int nsplit = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int p = pos[b];
  const int pair = b * Hkv * NG + hg;       // partials and ticket
  const int kvpair = b * Hkv + hk;          // k1, v1
  int* rowidx = reinterpret_cast<int*>(smem + C::OFF_ROW);
  unsigned char* ok = reinterpret_cast<unsigned char*>(smem + C::OFF_OK);
  unsigned* misc = reinterpret_cast<unsigned*>(smem + C::OFF_MISC);
  float* acc_ws = ws + ((size_t)pair * nsplit + split) * G * DH;
  float* ml_ws = ws + acc_floats(gridDim.z, Hkv * NG, nsplit, G, DH) +
                 ((size_t)pair * nsplit + split) * 2 * G;

  // 1. q (and, fused, k1 and v1) of the (head group, row) into shared memory
  // (the scores and the finish read them there); the split's positions:
  // cache rows, validity, tiles with a valid key
  char* qs = smem + C::OFF_Q;
  {
    const bf16* qg = q + ((size_t)b * H + (size_t)hg * G) * DH;
    constexpr int NROW = Out::kPartial ? G : G + 2;
    for (int c = tid; c < NROW * C::NCH; c += NT) {
      const bf16* src = qg + c * 8;
      if constexpr (!Out::kPartial)
        if (c >= G * C::NCH)
          src = (c < (G + 1) * C::NCH ? fin.k1 : fin.v1) +
                (size_t)kvpair * DH + (c % C::NCH) * 8;
      sm90::cp_async16(qs + c * 16, src, true);
    }
    sm90::cp_async_commit();
  }
  if (tid == 0) misc[0] = 0u;
  int rows[SPLIT / NT], cps[SPLIT / NT];
#pragma unroll
  for (int k = 0; k < SPLIT / NT; ++k) {
    const int j = split * SPLIT + k * NT + tid;
    rows[k] = j < Sc ? (int)layout.group(b, j) : 0;
  }
#pragma unroll
  for (int k = 0; k < SPLIT / NT; ++k)
    cps[k] = split * SPLIT + k * NT + tid < Sc ? __ldg(&cpos[rows[k]]) : -1;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < SPLIT / NT; ++k) {
    const int jj = k * NT + tid;
    const int cp = cps[k];
    const bool v = cp >= 0 && cp <= p && (!window || cp > p - window);
    rowidx[jj] = rows[k];
    ok[jj] = v;
    const unsigned bal = __ballot_sync(0xffffffffu, v);
    if (lane == 0 && bal) {
      constexpr int W = C::TJ < 32 ? C::TJ : 32;
      constexpr unsigned SEG = W == 32 ? 0xffffffffu : (1u << W) - 1u;
#pragma unroll
      for (int o = 0; o < 32; o += W)
        if ((bal >> o) & SEG)
          atomicOr(&misc[0], 1u << ((jj - lane + o) / C::TJ));
    }
  }
  __syncthreads();
  const unsigned tiles = misc[0];

  float m[G];
#pragma unroll
  for (int g = 0; g < G; ++g) m[g] = NEG_INF;

  if (tiles) {
    float* ps = reinterpret_cast<float*>(smem + C::OFF_P);
    float* wmax = reinterpret_cast<float*>(smem + C::OFF_WMAX);

    // K and V of tile `tile` into ring stage `stage`
    auto issue = [&](int tile, int stage) {
      char* kt = smem + stage * C::STAGE;
      char* vt = kt + C::TILE;
#pragma unroll 4
      for (int c = tid; c < C::TJ * C::NCH; c += NT) {
        const int jj = c / C::NCH, ch = c % C::NCH;
        const int js = tile * C::TJ + jj;
        const size_t off =
            ((size_t)rowidx[js] * Hkv + hk) * DH + (size_t)ch * 8;
        sm90::cp_async16(kt + jj * C::ROWB + ch * 16, ck + off, ok[js]);
        sm90::cp_async16(vt + jj * C::ROWB + ch * 16, cv + off, ok[js]);
      }
    };

    // P V: thread (r, ch) owns chunk ch of every head for positions r,
    // r + R, ... of each tile
    const bool pv = tid < C::R * C::NCH;
    const int r = tid / C::NCH, ch = tid % C::NCH;
    float l[G], acc[G][8];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
    }
    // scores: the NSEG lanes of position sj take its chunks seg, seg +
    // NSEG, ...
    const int sj = tid / C::NSEG, seg = tid % C::NSEG;

    // Every stage filled before the first wait (one commit group a tile);
    // then, from i = 1, tile i - 1 + STAGES goes into the stage tile i - 1
    // freed. At the wait of iteration i the groups after tile i's are the
    // STAGES - 1 (i = 0) or STAGES - 2 (i > 0) tiles issued after it.
    unsigned to_issue = tiles, to_do = tiles;
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      if (to_issue) {
        issue(__ffs(to_issue) - 1, s);
        to_issue &= to_issue - 1;
      }
      sm90::cp_async_commit();
    }
    for (int i = 0; to_do; ++i) {
      const int tile = __ffs(to_do) - 1;
      to_do &= to_do - 1;
      if (i)
        sm90::cp_async_wait<C::STAGES - 2>();
      else
        sm90::cp_async_wait<C::STAGES - 1>();
      __syncthreads();                      // tile i landed; tile i-1 done
      if (i) {
        if (to_issue) {
          issue(__ffs(to_issue) - 1, (i - 1) % C::STAGES);
          to_issue &= to_issue - 1;
        }
        sm90::cp_async_commit();
      }
      const char* kt = smem + (i % C::STAGES) * C::STAGE;
      const char* vt = kt + C::TILE;

      const bool v = ok[tile * C::TJ + sj];
      float s[G];
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] = 0.f;
      if (v) {
#pragma unroll
        for (int n = 0; n < C::NCH / C::NSEG; ++n) {
          const int c = seg + n * C::NSEG;
          float kf[8];
          unpack8(*reinterpret_cast<const uint4*>(kt + sj * C::ROWB + c * 16),
                  kf);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            float qf[8];
            unpack8(*reinterpret_cast<const uint4*>(qs + (g * DH + c * 8) * 2),
                    qf);
#pragma unroll
            for (int e = 0; e < 8; ++e) s[g] = fmaf(qf[e], kf[e], s[g]);
          }
        }
      }
#pragma unroll
      for (int o = 1; o < C::NSEG; o <<= 1)
#pragma unroll
        for (int g = 0; g < G; ++g)
          s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
      float t[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        s[g] *= scale;
        if (softcap > 0.f) s[g] = tanhf(s[g] / softcap) * softcap;
        t[g] = v ? s[g] : NEG_INF;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int g = 0; g < G; ++g)
          t[g] = fmaxf(t[g], __shfl_xor_sync(0xffffffffu, t[g], o));
      if (lane < G) {
#pragma unroll
        for (int g = 0; g < G; ++g)
          if (lane == g) wmax[warp * G + g] = t[g];
      }
      __syncthreads();                      // the warps' maxima
      float corr[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float mn = m[g];
#pragma unroll
        for (int w = 0; w < NW; ++w) mn = fmaxf(mn, wmax[w * G + g]);
        corr[g] = expf(m[g] - mn);
        m[g] = mn;
        if (g % C::NSEG == seg)
          ps[sj * G + g] = v ? expf(s[g] - mn) : 0.f;
      }
      __syncthreads();                      // p of the tile
      if (pv) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          l[g] *= corr[g];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] *= corr[g];
        }
        for (int jj = r; jj < C::TJ; jj += C::R) {
          float vf[8];
          unpack8(*reinterpret_cast<const uint4*>(vt + jj * C::ROWB + ch * 16),
                  vf);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float pj = ps[jj * G + g];
            l[g] += pj;
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pj, vf[e], acc[g][e]);
          }
        }
      }
    }

    // the position groups' sums meet in order r = 0, 1, ... in the ring
    sm90::cp_async_wait<0>();
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem);
    float* red_l = red + C::R * G * DH;
    if (pv) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float4* d = reinterpret_cast<float4*>(red + (r * G + g) * DH + ch * 8);
        d[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
        d[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
        if (ch == 0) red_l[r * G + g] = l[g];
      }
    }
    __syncthreads();
    for (int i = tid; i < G * DH / 4; i += NT) {
      float4 a = reinterpret_cast<const float4*>(red)[i];
      for (int rr = 1; rr < C::R; ++rr) {
        const float4 x =
            reinterpret_cast<const float4*>(red)[rr * G * DH / 4 + i];
        a.x += x.x;
        a.y += x.y;
        a.z += x.z;
        a.w += x.w;
      }
      reinterpret_cast<float4*>(acc_ws)[i] = a;
    }
    if (tid < G) {
      float ll = red_l[tid];
      for (int rr = 1; rr < C::R; ++rr) ll += red_l[rr * G + tid];
      ml_ws[G + tid] = ll;
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)               // NEG_INF: no valid key
    if (tid == g) ml_ws[g] = m[g];

  // 2. the last block of the (kv-head, row) to finish merges the splits
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int ticket = atomicAdd(&tickets[pair], 1);
    misc[1] = ticket == nsplit - 1;
  }
  __syncthreads();
  sm90::cp_async_wait<0>();                 // an empty split's staging
  if (!misc[1]) return;
  __threadfence();

  const float* acc_all = ws + (size_t)pair * nsplit * G * DH;
  const float* ml_all = ws + acc_floats(gridDim.z, Hkv * NG, nsplit, G, DH) +
                        (size_t)pair * nsplit * 2 * G;
  // head g = warp + gi * NW: mm the largest m of all splits, ll the sum of
  // l exp(m - mm) in split order
  float mm[C::GW], ll[C::GW];
#pragma unroll
  for (int gi = 0; gi < C::GW; ++gi) {
    const int g = warp + gi * NW;
    float x = NEG_INF;
    if (g < G)
      for (int s = lane; s < nsplit; s += 32)
        x = fmaxf(x, __ldcg(&ml_all[s * 2 * G + g]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    mm[gi] = x;
    ll[gi] = 0.f;
  }
  // acc, 32 splits at a time: the weights c = exp(m - mm) of a chunk (0 for
  // a split without a valid key, which is skipped) to shared memory, then
  // each thread sums its float4s of acc over the chunk in split order
  float* cw = reinterpret_cast<float*>(smem);          // [32][G]
  constexpr int NV = G * DH / 4, KV = (NV + NT - 1) / NT;
  float4 acc4[KV];
#pragma unroll
  for (int k = 0; k < KV; ++k) acc4[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = 0; s0 < nsplit; s0 += 32) {
    const int nc = min(32, nsplit - s0);
    __syncthreads();                        // the last chunk's weights used
#pragma unroll
    for (int gi = 0; gi < C::GW; ++gi) {
      const int g = warp + gi * NW;
      if (g >= G) continue;
      float c = 0.f, lc = 0.f;
      if (lane < nc) {
        const float m_s = __ldcg(&ml_all[(s0 + lane) * 2 * G + g]);
        if (m_s != NEG_INF) {
          c = expf(m_s - mm[gi]);
          lc = __ldcg(&ml_all[(s0 + lane) * 2 * G + G + g]) * c;
        }
      }
      cw[lane * G + g] = c;
      for (int k = 0; k < nc; ++k)
        ll[gi] += __shfl_sync(0xffffffffu, lc, k);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KV; ++k) {
      const int i = tid + k * NT;
      if (i >= NV) continue;
      const int g = i * 4 / DH;
      const float4* src = reinterpret_cast<const float4*>(acc_all) +
                          (size_t)s0 * NV + i;
#pragma unroll 8
      for (int j = 0; j < nc; ++j) {
        const float4 x = __ldcg(src + (size_t)j * NV);
        const float c = cw[j * G + g];
        if (c == 0.f) continue;
        acc4[k].x += x.x * c;
        acc4[k].y += x.y * c;
        acc4[k].z += x.z * c;
        acc4[k].w += x.w * c;
      }
    }
  }
  if constexpr (Out::kPartial) {
    // the merged partials as they are: acc [G][Dh] of the (kv-head, row)
    // from each thread's float4s, m and l from each head's warp
    float4* acc_out = reinterpret_cast<float4*>(fin.acc) + (size_t)pair * NV;
#pragma unroll
    for (int k = 0; k < KV; ++k)
      if (tid + k * NT < NV) acc_out[tid + k * NT] = acc4[k];
#pragma unroll
    for (int gi = 0; gi < C::GW; ++gi) {
      const int g = warp + gi * NW;
      if (g < G && lane == 0) {
        fin.m[(size_t)pair * G + g] = mm[gi];
        fin.l[(size_t)pair * G + g] = ll[gi];
      }
    }
  } else {
    float* merged = cw + 32 * G;                       // [G][Dh]
#pragma unroll
    for (int k = 0; k < KV; ++k)
      if (tid + k * NT < NV)
        reinterpret_cast<float4*>(merged)[tid + k * NT] = acc4[k];
    __syncthreads();
    const bf16* k1s = reinterpret_cast<const bf16*>(smem + C::OFF_KV1);
    const bf16* v1s = k1s + DH;
#pragma unroll
    for (int gi = 0; gi < C::GW; ++gi) {
      const int g = warp + gi * NW;
      if (g >= G) continue;
      float a[C::EPL];
#pragma unroll
      for (int e = 0; e < C::EPL; ++e)
        a[e] = lane_in<DH>(lane, e) ? merged[g * DH + lane + 32 * e] : 0.f;
      finish_row<DH, C::EPL>(
          reinterpret_cast<const bf16*>(qs) + g * DH, k1s, v1s,
          fin.out + ((size_t)b * H + (size_t)hg * G + g) * DH, lane, scale,
          softcap, mm[gi], ll[gi], a);
    }
  }
}

// The split body's launch: the call's ticket counters (the B * Hkv * NG
// int32 after the partials in ws) zeroed on the stream, then one kernel.
template <typename Layout, typename Out>
int launch(const void* q, const void* ck, const void* cv, const void* cpos,
           const void* pos, int B, int H, int Hkv, int Dh, int Sc,
           int window, float softcap, Layout layout, Out fin, void* ws,
           void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || !ws) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nsplit = Sc > SPLIT ? (Sc + SPLIT - 1) / SPLIT : 1;
  const int G = H / Hkv;
  int* tickets = reinterpret_cast<int*>(
      (float*)ws + acc_floats(B, Hkv, nsplit, G, Dh) +
      (size_t)B * Hkv * nsplit * 2 * G);
  return by_dh_g(Dh, G, [&](auto dh, auto g) -> int {
    constexpr int DH = decltype(dh)::value, GG = decltype(g)::value;
    if constexpr (!built<Out>(DH, GG)) {
      return (int)cudaErrorInvalidValue;
    } else {
      constexpr int GS = group_heads(GG), NG = head_groups(GG);
      auto kernel = decode_split_kernel<DH, GS, NG, Layout, Out>;
      static bool sized = false;
      cudaError_t err = sm90::allow_smem(kernel, sized);
      if (err == cudaSuccess)
        err = cudaMemsetAsync(tickets, 0, (size_t)B * Hkv * NG * sizeof(int),
                              st);
      if (err != cudaSuccess) return (int)err;
      kernel<<<dim3(nsplit, Hkv * NG, B), dim3(NT), Cfg<DH, GS>::BYTES,
               st>>>(
          (const bf16*)q, (const bf16*)ck, (const bf16*)cv, (const int*)cpos,
          (const int*)pos, H, Hkv, Sc, window, softcap,
          1.0f / sqrtf((float)DH), layout, fin, (float*)ws, tickets);
      return (int)cudaGetLastError();
    }
  });
}

}  // namespace split

// --------------------------------------------------------------------------
// The warp body's launch (float32 fused, paged and partial)
// --------------------------------------------------------------------------

template <typename T, typename Layout, typename Out>
int launch(const void* q, const void* ck, const void* cv, const void* cpos,
           const void* pos, int B, int H, int Hkv, int Dh, int Sc,
           int window, float softcap, Layout layout, Out fin, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_dh_g(Dh, H / Hkv, [&](auto dh, auto g) -> int {
    constexpr int DH = decltype(dh)::value, G = decltype(g)::value;
    if constexpr (!built<Out>(DH, G)) {
      return (int)cudaErrorInvalidValue;
    } else {
      constexpr int GS = group_heads(G), NG = head_groups(G);
      decode_attn_kernel<T, DH, GS, NG, Layout, Out>
          <<<dim3(Hkv * NG, B), dim3(NWARPS * 32), 0, st>>>(
              (const T*)q, (const T*)ck, (const T*)cv, (const int*)cpos,
              (const int*)pos, H, Hkv, Sc, window, softcap,
              1.0f / sqrtf((float)DH), layout, fin);
      return (int)cudaGetLastError();
    }
  });
}

}  // namespace

// 4-byte words of scratch the fused (Sc = the cache's) or paged (Sc = nblk
// * pt) kernel needs for one call: the split body's float32 partials and
// its int32 ticket counters in bfloat16, none in float32. Launches nothing.
extern "C" long long decode_attention_workspace(int B, int H, int Hkv,
                                                int Dh, int Sc, int dtype) {
  if (dtype != 1 || B <= 0 || Hkv <= 0 || H % Hkv != 0) return 0;
  const int nsplit =
      Sc > split::SPLIT ? (Sc + split::SPLIT - 1) / split::SPLIT : 1;
  return (long long)split::acc_floats(B, Hkv, nsplit, H / Hkv, Dh) +
         (long long)B * Hkv * nsplit * 2 * (H / Hkv) +
         (long long)B * Hkv * head_groups(H / Hkv);
}

// q [B,H,Dh]; ck/cv [B,Sc,Hkv,Dh]; cpos [B,Sc] int32; k1/v1 [B,Hkv,Dh];
// pos [B] int32 -> out [B,H,Dh]; all contiguous. (Dh, G = H / Hkv) as
// decode_attention_supports says. dtype 0 = float32, 1 = bfloat16. In
// bfloat16 (the split body) ws holds decode_attention_workspace words,
// whose ticket counters the launch zeroes on the stream first; float32 reads
// none (it may be null). Returns the first CUDA error of the launch.
extern "C" int decode_attention_fused(const void* q, const void* ck,
                                      const void* cv, const void* cpos,
                                      const void* k1, const void* v1,
                                      const void* pos, void* out, void* ws,
                                      int B, int H, int Hkv,
                                      int Dh, int Sc, int window,
                                      float softcap, int dtype,
                                      void* stream) {
  using bf16 = __nv_bfloat16;
  if (dtype == 1)
    return split::launch(q, ck, cv, cpos, pos, B, H, Hkv, Dh, Sc, window,
                         softcap, Contiguous{Sc},
                         Fused<bf16>{(const bf16*)k1, (const bf16*)v1,
                                     (bf16*)out},
                         ws, stream);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return launch<float>(q, ck, cv, cpos, pos, B, H, Hkv, Dh, Sc, window,
                       softcap, Contiguous{Sc},
                       Fused<float>{(const float*)k1, (const float*)v1,
                                    (float*)out},
                       stream);
}

// q [B,H,Dh]; pk/pv [P,pt,Hkv,Dh] page pools; ppos [P,pt] int32; bt
// [B,nblk] int32 with entries in [0, P); k1/v1 [B,Hkv,Dh]; pos [B] int32
// -> out [B,H,Dh]; all contiguous. pt a multiple of 4; no window. Same
// (Dh, G), dtype codes and scratch (Sc = nblk * pt) as
// decode_attention_fused.
extern "C" int decode_attention_paged(const void* q, const void* pk,
                                      const void* pv, const void* ppos,
                                      const void* bt, const void* k1,
                                      const void* v1, const void* pos,
                                      void* out, void* ws,
                                      int B, int H, int Hkv, int Dh, int pt,
                                      int nblk, float softcap, int dtype,
                                      void* stream) {
  using bf16 = __nv_bfloat16;
  if (pt <= 0 || pt % NJ != 0) return (int)cudaErrorInvalidValue;
  const Paged layout{(const int*)bt, nblk, pt};
  if (dtype == 1)
    return split::launch(q, pk, pv, ppos, pos, B, H, Hkv, Dh, nblk * pt, 0,
                         softcap, layout,
                         Fused<bf16>{(const bf16*)k1, (const bf16*)v1,
                                     (bf16*)out},
                         ws, stream);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return launch<float>(q, pk, pv, ppos, pos, B, H, Hkv, Dh, nblk * pt, 0,
                       softcap, layout,
                       Fused<float>{(const float*)k1, (const float*)v1,
                                    (float*)out},
                       stream);
}

// 4-byte words of scratch the partial kernel needs for one call: the
// fused kernel's at the same shapes (the split body in bfloat16, none in
// float32). Launches nothing.
extern "C" long long decode_attention_partial_workspace(int B, int H, int Hkv,
                                                        int Dh, int Sc,
                                                        int dtype) {
  return decode_attention_workspace(B, H, Hkv, Dh, Sc, dtype);
}

// q [B,H,Dh] (unscaled); ck/cv [B,Sc,Hkv,Dh]; cpos [B,Sc] int32; pos [B]
// int32 -> m, l [B,Hkv,G] and acc [B,Hkv,G,Dh], float32, contiguous. (Dh,
// G) as decode_attention_supports says; dtype codes (of q and the cache) as
// decode_attention_fused. In bfloat16 (the split body) ws holds
// decode_attention_partial_workspace words, whose ticket counters the
// launch zeroes on the stream first; float32 (the warp body) reads none.
extern "C" int decode_attention_partial(const void* q, const void* ck,
                                        const void* cv, const void* cpos,
                                        const void* pos, void* m, void* l,
                                        void* acc, void* ws, int B, int H,
                                        int Hkv, int Dh, int Sc, int window,
                                        float softcap, int dtype,
                                        void* stream) {
  const Partial fin{(float*)m, (float*)l, (float*)acc};
  if (dtype == 1)
    return split::launch(q, ck, cv, cpos, pos, B, H, Hkv, Dh, Sc, window,
                         softcap, Contiguous{Sc}, fin, ws, stream);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return launch<float>(q, ck, cv, cpos, pos, B, H, Hkv, Dh, Sc, window,
                       softcap, Contiguous{Sc}, fin, stream);
}

// Dynamic shared memory (bytes) of the split body (bfloat16 fused, paged
// and partial: one layout) at head dim dh and group size g; 0 where it is
// not built.
// Launches nothing.
extern "C" int decode_attention_split_smem(int dh, int g) {
  if (!fused_ok(dh, g)) return 0;
  return by_dh_g(dh, g, [](auto d, auto gg) -> int {
    constexpr int DH = decltype(d)::value, G = decltype(gg)::value;
    if constexpr (fused_ok(DH, G))
      return split::Cfg<DH, group_heads(G)>::BYTES;
    else
      return 0;
  });
}

// 1 if the kernels are built for head dim dh at group size g = H / Hkv:
// the fused and paged kernels (partial 0) or the partial kernel (partial
// 1); else 0. Launches nothing.
extern "C" int decode_attention_supports(int dh, int g, int partial) {
  return partial ? partial_ok(dh, g) : fused_ok(dh, g);
}
