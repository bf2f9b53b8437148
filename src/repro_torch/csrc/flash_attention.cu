// Full-sequence GQA attention (prefill) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel): online softmax over KV tiles with masks
// from explicit positions (kpos >= 0; causal kpos <= qpos; window
// kpos > qpos - window), optional tanh softcap; rows with no valid key
// output 0. Accumulation is float32; scores never leave the SM.
//
// A query "row" is one (position, grouped head) pair, so the G heads of a
// kv-head share every K/V tile a block stages. Two bodies:
//
// bfloat16: the tensor-core body (flash_tc_kernel). What bounds it on an
// H100: at prefill lengths operations, 4 * rows * keys * Dh for QK^T and
// PV, at the bf16 tensor-core rate. One block per (128-row query tile,
// kv-head, batch row): two consumer warpgroups of 64 rows each (one, on
// 64-row tiles, when the 128-row blocks would leave SMs idle). S = Q K^T
// is a wgmma with Q and K in shared memory (both K-major); O += P V is a
// wgmma with P in registers (the score accumulator's own layout) and V
// MN-major in shared memory. K/V tiles of BKV = 64 keys go through a ring
// of STAGES shared-memory stages filled by cp.async, so the next tiles
// load while this one is multiplied. The softmax is online over the key
// tiles in float32 registers; the 1/sqrt(Dh) scale and the softcap apply
// to the float32 scores. P enters PV as two bf16 operands, hi = bf16(p)
// and lo = bf16(p - hi) (two wgmma on the same V tile): a single bf16 P
// would cost up to 2^-9 of each term, above the half-ulp bar the bf16
// result is held to. p is 2^x by the special-function unit (ex2.approx)
// and lo is taken from hi's own bits: the softmax's instructions per score,
// not the tensor cores, set the pace at long S. Before the loop the block
// lists the key tiles in which some (row, key) pair of the block may be
// valid, from the block's qpos min and max and each tile's valid kpos
// (min, max, count) (causal early exit, the start of a window, tiles of
// kpos = -1): the others are not loaded. A tile valid for every pair
// skips the masks. A block whose rows have no position (idle batch rows
// of a chunk call) writes zeros and exits.
// Why a row's bits do not depend on the call (chunked == whole-prompt
// prefill): key tiles start at key index 0 and hold BKV keys whatever Sk,
// B or Sq; a key that is masked for a row gets p = 0 exactly and leaves
// that row's running max alone, so a tile without a valid key for the row
// (or a skipped one) is an exact no-op for it (the correction is set to 1
// when the max does not move, products with 0); and each row's sums
// depend on its own scores only, whichever row of a 64- or 128-row tile
// it takes.
//
// float32: the CUDA-core body (flash_attn_kernel), kept as it was: float32
// on tensor cores would be TF32, which misses the 2e-5 bar. One block per
// (16-row query tile, kv-head, batch row). Each of the four warps owns
// four rows; the 32 lanes split the head dimension (a head dimension that
// is not a multiple of 32, such as 112 or 80, is zero-filled to the next
// one in registers and shared memory) and every score is a warp-wide
// reduction. KV tiles are a fixed BKV keys per head dim whatever the
// padded extent (32; 16 at head dim 256, whose float32 K and V tiles
// would otherwise take 64 KB, above the 48 KB a block may declare
// statically), and keys are visited one at a time in ascending order, so
// the tile size changes no arithmetic; a masked key is skipped, which is
// exactly the no-op it is in the block update, so the result does not
// depend on how far the KV axis was padded.
#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace repro;

constexpr int NWARPS = 4;
constexpr int R = 4;                        // query rows per warp
constexpr int ROWS = NWARPS * R;            // query rows per block

template <typename T, int DH>
__global__ void __launch_bounds__(NWARPS * 32)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ qpos,
                  const int* __restrict__ kpos, T* __restrict__ out, int Sq,
                  int Sk, int H, int Hkv, int G, int causal, int window,
                  float softcap, float scale) {
  constexpr int EPL = (DH + 31) / 32;       // head elements per lane
  constexpr int DP = EPL * 32;
  constexpr int BKV = DH > 128 ? 16 : 32;   // keys per shared-memory tile
  // whether lane element e lies inside the head (always, when DH % 32 == 0)
  auto in = [](int lane, int e) { return DH % 32 == 0 || lane + 32 * e < DH; };
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
      off = (((size_t)b * Sq + i) * H + (size_t)hk * G + g) * DH + lane;
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      acc[r][e] = 0.f;
      qr[r][e] = live[r] && in(lane, e) ? to_f(q[off + 32 * e]) * scale
                                        : 0.f;
    }
  }

  __shared__ float ks[BKV][DP];
  __shared__ float vs[BKV][DP];
  __shared__ int kps[BKV];
  for (int j0 = 0; j0 < Sk; j0 += BKV) {
    for (int idx = threadIdx.x; idx < BKV * DP; idx += NWARPS * 32) {
      const int jj = idx / DP;
      const int d = idx % DP;
      const int j = j0 + jj;
      float kv = 0.f, vv = 0.f;
      if (j < Sk && d < DH) {
        const size_t off = (((size_t)b * Sk + j) * Hkv + hk) * DH + d;
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
    const size_t off = (((size_t)b * Sq + i) * H + (size_t)hk * G + g) * DH + lane;
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      if (in(lane, e))
        store(&out[off + 32 * e],
              l[r] > 0.f ? acc[r][e] / fmaxf(l[r], 1e-30f) : 0.f);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor-core body
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int TC_BKV = 64;                  // keys per tile, every head dim
constexpr int FULL_TILE = 1 << 30;          // tile list: every pair valid
constexpr float LOG2E = 1.4426950408889634f;

template <int DH, int NWG_>
struct TcCfg {
  static constexpr int NWG = NWG_;          // consumer warpgroups
  static constexpr int ROWS = 64 * NWG;     // query rows per block
  static constexpr int NT = 128 * NWG;
  static constexpr int STAGES = DH > 128 ? 2 : 3;
  // two blocks per SM up to head dim 128 (registers capped at 128 a
  // thread, no spill: ptxas -v); at 256 one block takes most of the
  // shared memory
  static constexpr int MIN_BLOCKS = DH > 128 ? 1 : 2;
  static constexpr int Q_BYTES = ROWS * DH * 2;
  static constexpr int T_BYTES = TC_BKV * DH * 2;      // one K or V tile
  static constexpr int STAGE_BYTES = 2 * T_BYTES + TC_BKV * 4;
  static constexpr int FIXED = Q_BYTES + STAGES * STAGE_BYTES;
};

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(~0u, v, o));
  return v;
}
__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

template <int DH, int NWG>
__global__ void __launch_bounds__(TcCfg<DH, NWG>::NT, TcCfg<DH, NWG>::MIN_BLOCKS)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const int* __restrict__ qpos,
                const int* __restrict__ kpos, bf16* __restrict__ out,
                int Sq, int Sk, int H, int Hkv, int G, int causal,
                int window, float softcap, float scale) {
  using Cfg = TcCfg<DH, NWG>;
  constexpr int NT = Cfg::NT, STAGES = Cfg::STAGES;
  extern __shared__ __align__(128) char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  char* stage0 = smem + Cfg::Q_BYTES;
  int* tiles = reinterpret_cast<int*>(stage0 + STAGES * Cfg::STAGE_BYTES);
  __shared__ int s_qmin, s_qmax, s_dead, s_ntiles;

  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * Cfg::ROWS;  // long rows first
  const int nrows = Sq * G;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nt = (Sk + TC_BKV - 1) / TC_BKV;
  auto row_off = [&](int row) {              // element offset of a row
    return (((size_t)b * Sq + row / G) * H + (size_t)hk * G + row % G) * DH;
  };

  // Q first: its copy overlaps the scans below (it joins the first
  // committed group, with the first key tile)
  sm90::stage_tile<Cfg::ROWS, DH, NT>(qs, [&](int r, int cg, bool& ok) {
    ok = r0 + r < nrows;
    return q + (ok ? row_off(r0 + r) : 0) + cg * 8;
  });

  // 1. the block's query positions (the rows a key may be valid for) and,
  // at the same time, each key tile's valid positions (min, max, count)
  if (tid == 0) {
    s_qmin = 0x7fffffff;
    s_qmax = -0x7fffffff;
    s_dead = 0;
  }
  int lo = 0x7fffffff, hi = -0x7fffffff;
  bool dead = false;                          // a row that sees no key
  for (int r = tid; r < Cfg::ROWS; r += NT) {
    const int row = r0 + r;
    if (row < nrows) {
      const int qp = qpos[(size_t)b * Sq + row / G];
      if (!causal || qp >= 0) {
        lo = min(lo, qp);
        hi = max(hi, qp);
      } else {
        dead = true;
      }
    }
  }
  for (int t = warp; t < nt; t += NT / 32) {
    int kmin = 0x7fffffff, kmax = -0x7fffffff, n = 0;
    for (int jj = lane; jj < TC_BKV; jj += 32) {
      const int j = t * TC_BKV + jj;
      const int kp = j < Sk ? kpos[(size_t)b * Sk + j] : -1;
      if (kp >= 0) {
        kmin = min(kmin, kp);
        kmax = max(kmax, kp);
        ++n;
      }
    }
    kmin = __reduce_min_sync(~0u, kmin);
    kmax = __reduce_max_sync(~0u, kmax);
    n = __reduce_add_sync(~0u, n);
    if (lane == 0) {
      tiles[nt + 3 * t] = kmin;
      tiles[nt + 3 * t + 1] = kmax;
      tiles[nt + 3 * t + 2] = n;
    }
  }
  lo = __reduce_min_sync(~0u, lo);
  hi = __reduce_max_sync(~0u, hi);
  dead = __any_sync(~0u, dead);
  __syncthreads();                            // the initial values are set
  if (lane == 0) {
    atomicMin(&s_qmin, lo);
    atomicMax(&s_qmax, hi);
    if (dead) s_dead = 1;
  }
  __syncthreads();
  const int qmin = s_qmin, qmax = s_qmax;
  if (qmin > qmax) {                          // no row can see a key
    sm90::cp_async_wait<0>();
    for (int c = tid; c < Cfg::ROWS * DH / 8; c += NT) {
      const int row = r0 + c / (DH / 8);
      if (row < nrows)
        *reinterpret_cast<uint4*>(out + row_off(row) + (c % (DH / 8)) * 8) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  // 2. the key tiles in which some (row, key) pair of the block may be
  // valid, ascending (a tile whose valid positions span the rows' range is
  // kept; one without a valid pair is then an exact no-op); a tile is
  // full when every key in it is valid for every row (then its softmax
  // skips the masks: the same arithmetic on every score)
  if (warp == 0) {
    int n = 0;
    for (int t0 = 0; t0 < nt; t0 += 32) {
      const int t = t0 + lane;
      bool live = false, full = false;
      if (t < nt) {
        const int kmin = tiles[nt + 3 * t], kmax = tiles[nt + 3 * t + 1];
        const int cnt = tiles[nt + 3 * t + 2];
        live = cnt > 0 && (!causal || kmin <= qmax) &&
               (!window || kmax > qmin - window);
        full = cnt == TC_BKV && !s_dead && (!causal || kmax <= qmin) &&
               (!window || kmin > qmax - window);
      }
      const unsigned m = __ballot_sync(~0u, live);
      if (live) tiles[n + __popc(m & ((1u << lane) - 1u))] =
          t | (full ? FULL_TILE : 0);
      n += __popc(m);
    }
    if (lane == 0) s_ntiles = n;
  }
  __syncthreads();
  const int ntiles = s_ntiles;

  // 3. the ring of K/V stages (one cp.async group per tile)
  auto load_tile = [&](int s, int t) {
    char* st = stage0 + s * Cfg::STAGE_BYTES;
    const int j0 = t * TC_BKV;
    auto src = [&](const bf16* base) {
      return [=](int r, int cg, bool& ok) {
        ok = j0 + r < Sk;
        return base + (((size_t)b * Sk + (ok ? j0 + r : 0)) * Hkv + hk) * DH +
               cg * 8;
      };
    };
    sm90::stage_tile<TC_BKV, DH, NT>(reinterpret_cast<bf16*>(st), src(k));
    sm90::stage_tile<TC_BKV, DH, NT>(
        reinterpret_cast<bf16*>(st + Cfg::T_BYTES), src(v));
    if (tid < TC_BKV) {                       // positions; past Sk: 0, masked
      const bool ok = j0 + tid < Sk;
      sm90::cp_async4(st + 2 * Cfg::T_BYTES + tid * 4,
                      kpos + (size_t)b * Sk + (ok ? j0 + tid : 0), ok);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) load_tile(s, tiles[s]);
    sm90::cp_async_commit();
  }

  // this thread's two rows of its warpgroup's 64
  const int wg = tid >> 7, t = tid & 127;
  int qp[2];
  bool in[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + wg * 64 + sm90::frag_row(t, 2 * h);
    in[h] = row < nrows;
    qp[h] = in[h] ? qpos[(size_t)b * Sq + row / G] : -1;
  }
  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};            // running max, log2 units
  float l[2] = {0.f, 0.f};                    // this thread's share of sum p
  // scores in log2 units: s * scale * log2(e), or with a softcap c
  // tanh(s * scale / c) * c * log2(e)
  const float c1 = scale * LOG2E;
  const float cap_in = softcap > 0.f ? scale / softcap : 0.f;
  const float cap_out = softcap * LOG2E;
  const uint64_t dq = sm90::desc(qs + wg * 64 * DH, 128, DH * 16);

  using Frag = uint32_t[TC_BKV / 16][4];      // P (hi or lo) as A operands
  auto stage = [&](int it) {
    return stage0 + (it % STAGES) * Cfg::STAGE_BYTES;
  };
  // S = Q K^T of the tile in stage st, issued (one wgmma group)
  auto qk = [&](const char* st, float (&sc)[TC_BKV / 2]) {
#pragma unroll
    for (int i = 0; i < TC_BKV / 2; ++i) sc[i] = 0.f;
    sm90::wgmma_fence();
    const uint64_t dk = sm90::desc(st, 128, DH * 16);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      sm90::wgmma_ss_n64(sc, dq + kk * 16, dk + kk * 16, 1);
    sm90::wgmma_commit();
  };
  // O += P_hi V + P_lo V of the tile in stage st, issued (one group)
  auto pv = [&](const char* st, Frag& ph, Frag& pl) {
    sm90::wgmma_fence();
    const uint64_t dv = sm90::desc(st + Cfg::T_BYTES, DH * 16, 128);
#pragma unroll
    for (int kk = 0; kk < TC_BKV / 16; ++kk) {
      sm90::wgmma_rs(o, ph[kk], dv + kk * (2 * DH * 16 >> 4), 1);
      sm90::wgmma_rs(o, pl[kk], dv + kk * (2 * DH * 16 >> 4), 1);
    }
    sm90::wgmma_commit();
  };
  // the online softmax of tile it's scores: scale, softcap and masks, the
  // running max and sum, and P as hi + lo bf16 fragments (masked p exactly
  // 0); corr rescales O (exactly 1 where the max did not move). A full
  // tile has no masked score, and every score takes the same arithmetic
  // either way.
  auto softmax = [&](int it, float (&sc)[TC_BKV / 2], Frag& ph, Frag& pl,
                     float (&corr)[2]) {
    const int* kps =
        reinterpret_cast<const int*>(stage(it) + 2 * Cfg::T_BYTES);
    const bool full = tiles[it] & FULL_TILE;
    const int jn = Sk - (tiles[it] & ~FULL_TILE) * TC_BKV;  // keys below Sk
    uint32_t ok = 0;
    float mt[2] = {m[0], m[1]};
#pragma unroll
    for (int nb = 0; nb < TC_BKV / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int jj = sm90::frag_col(t, nb * 4 + e);
        const int kp = kps[jj];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = nb * 4 + 2 * h + e;
          sc[i] = softcap > 0.f ? tanhf(sc[i] * cap_in) * cap_out
                                : sc[i] * c1;
          const bool valid =
              full || (jj < jn && kp >= 0 && (!causal || kp <= qp[h]) &&
                       (!window || kp > qp[h] - window));
          if (valid) {
            ok |= 1u << i;
            mt[h] = fmaxf(mt[h], sc[i]);
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(~0u, mt[h], 1));
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(~0u, mt[h], 2));
      corr[h] = mt[h] == m[h] ? 1.f : sm90::ex2(m[h] - mt[h]);
      m[h] = mt[h];
      l[h] *= corr[h];
    }
#pragma unroll
    for (int i = 0; i < TC_BKV / 2; i += 2) {
      const int h = (i >> 1) & 1;
      float pe[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        pe[e] = (ok >> (i + e)) & 1u ? sm90::ex2(sc[i + e] - m[h]) : 0.f;
        l[h] += pe[e];
      }
      // accumulator pair i / 2 -> A fragment (k step, register): hi, and
      // lo = p - hi from hi's own bits
      const int nb = i >> 2, kstep = nb >> 1;
      const int reg = (nb & 1) * 2 + h;
      const uint32_t hi = sm90::pack_bf16(pe[0], pe[1]);
      ph[kstep][reg] = hi;
      pl[kstep][reg] = sm90::pack_bf16(pe[0] - __uint_as_float(hi << 16),
                                       pe[1] - __uint_as_float(hi & 0xffff0000u));
    }
  };
  auto rescale = [&](const float (&corr)[2]) {
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] *= corr[(i >> 1) & 1];
  };

  // one tile at a time; the ring keeps the next tiles' copies in flight
  for (int it = 0; it < ntiles; ++it) {
    sm90::cp_async_wait<STAGES - 2>();
    sm90::fence_proxy_async();
    __syncthreads();                          // tile it landed; it - 1 done
    if (it + STAGES - 1 < ntiles)
      load_tile((it + STAGES - 1) % STAGES,
                tiles[it + STAGES - 1] & ~FULL_TILE);
    sm90::cp_async_commit();
    float sc[TC_BKV / 2], corr[2];
    Frag ph, pl;
    qk(stage(it), sc);
    sm90::wgmma_wait<0>();
    sm90::pin(sc);
    softmax(it, sc, ph, pl, corr);
    rescale(corr);
    pv(stage(it), ph, pl);
    sm90::wgmma_wait<0>();
    sm90::pin(o);
  }
  sm90::cp_async_wait<0>();

  // normalise and store this thread's two rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lh = l[h];
    lh += __shfl_xor_sync(~0u, lh, 1);
    lh += __shfl_xor_sync(~0u, lh, 2);
    if (!in[h]) continue;
    bf16* dst = out + row_off(r0 + wg * 64 + sm90::frag_row(t, 2 * h));
#pragma unroll
    for (int nb = 0; nb < DH / 8; ++nb) {
      const float a = o[nb * 4 + 2 * h], c = o[nb * 4 + 2 * h + 1];
      const float d = fmaxf(lh, 1e-30f);
      *reinterpret_cast<uint32_t*>(dst + sm90::frag_col(t, nb * 4)) =
          lh > 0.f ? sm90::pack_bf16(a / d, c / d) : 0u;
    }
  }
}

template <int DH, int NWG>
cudaError_t launch_tc_nwg(const void* q, const void* k, const void* v,
                          const int* qpos, const int* kpos, void* out, int B,
                          int Sq, int Sk, int H, int Hkv, int causal,
                          int window, float softcap, float scale,
                          cudaStream_t st) {
  using Cfg = TcCfg<DH, NWG>;
  const int G = H / Hkv;
  // tile list and each tile's (min, max, count) of valid positions
  const size_t smem = Cfg::FIXED + (size_t)((Sk + TC_BKV - 1) / TC_BKV) * 16;
  if (smem > (size_t)sm90::SMEM_MAX) return cudaErrorInvalidValue;
  static bool sized = false;
  const cudaError_t err = sm90::allow_smem(flash_tc_kernel<DH, NWG>, sized);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq * G + Cfg::ROWS - 1) / Cfg::ROWS, Hkv, B);
  flash_tc_kernel<DH, NWG><<<grid, Cfg::NT, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, qpos, kpos,
      (bf16*)out, Sq, Sk, H, Hkv, G, causal, window, softcap, scale);
  return cudaGetLastError();
}

// Two warpgroups (128 rows) per block share each K/V tile; a call whose
// 128-row blocks would not cover the SMs takes 64-row blocks, twice as
// many. A row's arithmetic is the same either way.
template <int DH>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const int* qpos, const int* kpos, void* out, int B,
                      int Sq, int Sk, int H, int Hkv, int causal, int window,
                      float softcap, float scale, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((Sq * (H / Hkv) + 127) / 128) * Hkv * B;
  if (blocks < sms)
    return launch_tc_nwg<DH, 1>(q, k, v, qpos, kpos, out, B, Sq, Sk, H, Hkv,
                                causal, window, softcap, scale, st);
  return launch_tc_nwg<DH, 2>(q, k, v, qpos, kpos, out, B, Sq, Sk, H, Hkv,
                              causal, window, softcap, scale, st);
}

enum Path { TENSOR_CORE = 0, CUDA_CORE = 1 };

// bfloat16 takes the tensor cores, float32 the CUDA cores; -1: no kernel
int choose_path(int dtype) {
  return dtype == 1 ? TENSOR_CORE : dtype == 0 ? CUDA_CORE : -1;
}

cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* qpos, const int* kpos, void* out, int B, int Sq,
                   int Sk, int H, int Hkv, int Dh, int causal, int window,
                   float softcap, int dtype, cudaStream_t st) {
  const int G = H / Hkv;
  const float scale = 1.0f / sqrtf((float)Dh);
  if (choose_path(dtype) == TENSOR_CORE) {
#define TC_ARGS q, k, v, qpos, kpos, out, B, Sq, Sk, H, Hkv, causal, window, \
                softcap, scale, st
    switch (Dh) {
      case 32: return launch_tc<32>(TC_ARGS);
      case 64: return launch_tc<64>(TC_ARGS);
      case 80: return launch_tc<80>(TC_ARGS);
      case 112: return launch_tc<112>(TC_ARGS);
      case 128: return launch_tc<128>(TC_ARGS);
      case 256: return launch_tc<256>(TC_ARGS);
      default: return cudaErrorInvalidValue;
    }
#undef TC_ARGS
  }
  if (choose_path(dtype) != CUDA_CORE) return cudaErrorInvalidValue;
  const dim3 grid((Sq * G + ROWS - 1) / ROWS, Hkv, B);
  const dim3 block(NWARPS * 32);
#define FLASH_ARGS                                                         \
  (const float*)q, (const float*)k, (const float*)v, qpos, kpos,           \
      (float*)out, Sq, Sk, H, Hkv, G, causal, window, softcap, scale
  switch (Dh) {
    case 32: flash_attn_kernel<float, 32><<<grid, block, 0, st>>>(FLASH_ARGS); break;
    case 64: flash_attn_kernel<float, 64><<<grid, block, 0, st>>>(FLASH_ARGS); break;
    case 80: flash_attn_kernel<float, 80><<<grid, block, 0, st>>>(FLASH_ARGS); break;
    case 112: flash_attn_kernel<float, 112><<<grid, block, 0, st>>>(FLASH_ARGS); break;
    case 128: flash_attn_kernel<float, 128><<<grid, block, 0, st>>>(FLASH_ARGS); break;
    case 256: flash_attn_kernel<float, 256><<<grid, block, 0, st>>>(FLASH_ARGS); break;
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_ARGS
  return cudaGetLastError();
}

}  // namespace

// q [B,Sq,H,Dh]; k/v [B,Sk,Hkv,Dh]; qpos [B,Sq], kpos [B,Sk] int32 (-1 =
// invalid) -> out [B,Sq,H,Dh]; all contiguous; Dh as
// flash_attention_supports says. dtype 0 = float32 (CUDA cores), 1 =
// bfloat16 (tensor cores). Returns cudaGetLastError() after the launch.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               const void* qpos, const void* kpos, void* out,
                               int B, int Sq, int Sk, int H, int Hkv, int Dh,
                               int causal, int window, float softcap,
                               int dtype, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  return (int)launch(q, k, v, (const int*)qpos, (const int*)kpos, out, B, Sq,
                     Sk, H, Hkv, Dh, causal, window, softcap, dtype,
                     static_cast<cudaStream_t>(stream));
}

// The path flash_attention takes for a dtype: 0 = tensor cores, 1 = CUDA
// cores; -1 for an unknown dtype. Launches nothing.
extern "C" int flash_attention_path(int dtype) { return choose_path(dtype); }

// 1 if the kernel is built for head dim dh (the cases of launch), else 0.
// Launches nothing.
extern "C" int flash_attention_supports(int dh) {
  return dh == 32 || dh == 64 || dh == 80 || dh == 112 || dh == 128 ||
         dh == 256;
}
