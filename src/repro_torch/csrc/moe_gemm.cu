// Grouped MoE expert FFN for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/moe_gemm.py::moe_gemm
// (_moe_ffn_kernel / _moe_ffn_body): per physical expert slot p,
//     y[p] = (act(x[p] @ wg[e]) * (x[p] @ wu[e])) @ wd[e],   e = slot_expert[p]
// with an ungated variant, float32 accumulation, and slots whose routed
// token count is 0 skipped (their output is 0).
//
// The weights are read straight from the stored per-expert bank through
// the slot -> expert index, so the 16-slot physical bank (8 primaries and
// 8 shadows for Mixtral on 2 EWs) is never materialised: no per-layer copy
// of the expert weights, and shadow slots without traffic cost nothing.
//
// What bounds it on an H100: at decode (C = capacity of a few tokens per
// slot) bytes -- every active slot streams 3 * D * F weights once for ~2C
// flops each; at prefill (C in the tens to hundreds) operations, which
// the tensor-core path runs through wgmma fed by asynchronous copies.
//
// Design: the TPU kernel accumulates the down projection across sequential
// F tiles; blocks here run in parallel, so the FFN is two GEMM-shaped
// passes with the hidden activation in float32 scratch between them
// (act(g) * u applied when the gate/up sums are complete). Three paths,
// chosen from the kind of call (the caller says whether it is a decode
// step), the dtype, C and alignment:
//   * skinny, the decode path (decode steps only; bytes-bound): in bf16 at
//     C <= 8, two persistent launches over the live slots' tiles (the
//     down pass a programmatic dependent launch of the gate/up pass) that
//     stream the weights through a TMA-fed ring into the swapped wgmma
//     (64 weight columns as M, the tokens padded to 8 as N); in float32 at
//     C <= 4, threads that stream 16-byte vectors of weight columns with
//     the reduction axis split over blocks and the split partials summed
//     in a fixed order by small finalize kernels (deterministic, no
//     atomics);
//   * tensor-core tile (bf16: every prefill and chunk call, whatever
//     its C, and decode steps at C > 8): wgmma (m64n128k16, float32
//     accumulators) on operand tiles that cp.async keeps several stages
//     ahead in shared memory; the hidden activation enters the down
//     product as a hi + lo pair of bf16 operands (two wgmma per step);
//   * CUDA-core tile (float32, and shapes the other paths cannot take):
//     one block per (128 columns, BM-row tile, slot), x staged in shared
//     memory, one column per thread with BM float32 sums in registers
//     (BM = 16 or 64 from C).
// Every path computes a slot only from its expert's rows and its own x, so
// a shadow slot reproduces its primary bit for bit, and gives a token's
// row the same bits whatever C and whichever row of the slot it takes.
// The decode path and the tile paths round differently: so only a decode
// step may take the decode path, and a token's bits in a prefill or chunk
// call never depend on how many tokens share the call (chunked ==
// whole-prompt prefill).
#include <cuda_bf16.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace repro;

constexpr int NT = 128;    // threads per block = columns per block
constexpr int BK = 16;     // reduction depth per shared-memory stage

template <typename T, int BM, bool GATED>
__global__ void __launch_bounds__(NT)
moe_gate_up_kernel(const T* __restrict__ x, const T* __restrict__ wg,
                   const T* __restrict__ wu,
                   const int* __restrict__ slot_expert,
                   const int* __restrict__ counts, float* __restrict__ hidden,
                   int C, int D, int F, int act) {
  const int p = blockIdx.z;
  if (counts[p] <= 0) return;                   // block-uniform
  const int e = max(slot_expert[p], 0);
  const int m0 = blockIdx.y * BM;
  const int f = blockIdx.x * NT + threadIdx.x;
  const T* xp = x + (size_t)p * C * D;
  const T* wgp = wg + (size_t)e * D * F;
  const T* wup = wu + (size_t)e * D * F;

  __shared__ float xs[BK][BM + 1];
  float ag[BM], au[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) ag[i] = au[i] = 0.f;

  for (int k0 = 0; k0 < D; k0 += BK) {
    for (int idx = threadIdx.x; idx < BK * BM; idx += NT) {
      const int mm = idx / BK;
      const int kk = idx % BK;
      const int mrow = m0 + mm;
      const int k = k0 + kk;
      xs[kk][mm] = (mrow < C && k < D) ? to_f(xp[(size_t)mrow * D + k]) : 0.f;
    }
    __syncthreads();
    if (f < F) {
      const int kn = min(BK, D - k0);
#pragma unroll 4
      for (int kk = 0; kk < kn; ++kk) {
        const size_t w = (size_t)(k0 + kk) * F + f;
        const float u = to_f(wup[w]);
        const float g = GATED ? to_f(wgp[w]) : 0.f;
#pragma unroll
        for (int i = 0; i < BM; ++i) {
          const float xv = xs[kk][i];
          au[i] += xv * u;
          if (GATED) ag[i] += xv * g;
        }
      }
    }
    __syncthreads();
  }
  if (f >= F) return;
#pragma unroll
  for (int i = 0; i < BM; ++i) {
    const int mrow = m0 + i;
    if (mrow < C) {
      const float h = GATED ? act_fn(ag[i], act) * au[i] : act_fn(au[i], act);
      hidden[((size_t)p * C + mrow) * F + f] = h;
    }
  }
}

template <typename T, int BM>
__global__ void __launch_bounds__(NT)
moe_down_kernel(const float* __restrict__ hidden, const T* __restrict__ wd,
                const int* __restrict__ slot_expert,
                const int* __restrict__ counts, T* __restrict__ y, int C,
                int D, int F) {
  const int p = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n = blockIdx.x * NT + threadIdx.x;
  if (counts[p] <= 0) {                         // block-uniform
    if (n < D)
      for (int i = 0; i < BM && m0 + i < C; ++i)
        store(&y[((size_t)p * C + m0 + i) * D + n], 0.f);
    return;
  }
  const int e = max(slot_expert[p], 0);
  const float* hp = hidden + (size_t)p * C * F;
  const T* wdp = wd + (size_t)e * F * D;

  __shared__ float hs[BK][BM + 1];
  float acc[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < F; k0 += BK) {
    for (int idx = threadIdx.x; idx < BK * BM; idx += NT) {
      const int mm = idx / BK;
      const int kk = idx % BK;
      const int mrow = m0 + mm;
      const int k = k0 + kk;
      hs[kk][mm] = (mrow < C && k < F) ? hp[(size_t)mrow * F + k] : 0.f;
    }
    __syncthreads();
    if (n < D) {
      const int kn = min(BK, F - k0);
#pragma unroll 4
      for (int kk = 0; kk < kn; ++kk) {
        const float w = to_f(wdp[(size_t)(k0 + kk) * D + n]);
#pragma unroll
        for (int i = 0; i < BM; ++i) acc[i] += hs[kk][i] * w;
      }
    }
    __syncthreads();
  }
  if (n >= D) return;
#pragma unroll
  for (int i = 0; i < BM; ++i)
    if (m0 + i < C) store(&y[((size_t)p * C + m0 + i) * D + n], acc[i]);
}

// ---------------------------------------------------------------------------
// Float32 skinny path (decode steps at C <= 4): bytes-bound weight
// streaming. Each thread owns 16 bytes of columns (4 float32 values, one
// vector load per weight row) and the reduction axis is split over
// blockIdx.y so that enough loads are in flight to approach the memory
// rate. Split partials go to float32 scratch and are summed in split order
// by the finalize kernels: deterministic, and independent of which slot
// serves an expert (so a shadow slot reproduces its primary bit for bit).
// bf16 decode steps take the decode path further down.
// ---------------------------------------------------------------------------

constexpr int SK_NT = 128;            // threads per skinny block
constexpr int TARGET_BLOCKS = 2048;   // blocks to aim for per launch
constexpr int MAX_KCHUNK = 2048;      // BM * MAX_KCHUNK floats of smem

constexpr int V = 4;                  // float32 columns per thread

__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

// part[s, p, m, n] = sum over k in split s of A[p, m, k] * W[e, k, n]
// (and the same for W1 when DUAL). A: [P, C, K]; W: [E, K, N].
template <int BM, bool DUAL>
__global__ void __launch_bounds__(SK_NT)
skinny_partial_kernel(const float* __restrict__ A, const float* __restrict__ W0,
                      const float* __restrict__ W1,
                      const int* __restrict__ slot_expert,
                      const int* __restrict__ counts,
                      float* __restrict__ part0, float* __restrict__ part1,
                      int P, int C, int K, int N, int kchunk) {
  const int p = blockIdx.z;
  if (counts[p] <= 0) return;                   // block-uniform
  const int s = blockIdx.y;
  const int k0 = s * kchunk;
  const int kn = min(kchunk, K - k0);
  const int e = max(slot_expert[p], 0);
  const int n0 = (blockIdx.x * SK_NT + threadIdx.x) * V;

  extern __shared__ float as[];                 // [BM][kchunk]
  for (int idx = threadIdx.x; idx < BM * kchunk; idx += SK_NT) {
    const int m = idx / kchunk;
    const int kk = idx % kchunk;
    as[idx] = (m < C && kk < kn) ? A[((size_t)p * C + m) * K + k0 + kk] : 0.f;
  }
  __syncthreads();
  if (n0 >= N) return;

  float acc0[BM][V], acc1[BM][V];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int v = 0; v < V; ++v) acc0[m][v] = acc1[m][v] = 0.f;

  const float* w0 = W0 + ((size_t)e * K + k0) * N + n0;
  const float* w1 = DUAL ? W1 + ((size_t)e * K + k0) * N + n0 : nullptr;
#pragma unroll 4
  for (int kk = 0; kk < kn; ++kk) {
    float a[V], b[V];
    load16(w0 + (size_t)kk * N, a);
    if (DUAL) load16(w1 + (size_t)kk * N, b);
#pragma unroll
    for (int m = 0; m < BM; ++m) {
      const float xv = as[m * kchunk + kk];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        acc0[m][v] += xv * a[v];
        if (DUAL) acc1[m][v] += xv * b[v];
      }
    }
  }
#pragma unroll
  for (int m = 0; m < BM; ++m) {
    if (m < C) {
      const size_t off = (((size_t)s * P + p) * C + m) * N + n0;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        part0[off + v] = acc0[m][v];
        if (DUAL) part1[off + v] = acc1[m][v];
      }
    }
  }
}

// hidden = act(sum_s gate) * sum_s up (gated) or act(sum_s up)
__global__ void finalize_hidden_kernel(const float* __restrict__ part0,
                                       const float* __restrict__ part1,
                                       const int* __restrict__ counts,
                                       float* __restrict__ hidden, int P,
                                       int C, int F, int S, int gated,
                                       int act) {
  const size_t n = (size_t)P * C * F;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  if (counts[idx / ((size_t)C * F)] <= 0) return;
  float a = 0.f, b = 0.f;
  for (int s = 0; s < S; ++s) {
    a += part0[s * n + idx];
    if (gated) b += part1[s * n + idx];
  }
  hidden[idx] = gated ? act_fn(a, act) * b : act_fn(a, act);
}

__global__ void finalize_out_kernel(const float* __restrict__ part,
                                    const int* __restrict__ counts,
                                    float* __restrict__ y, int P, int C,
                                    int D, int S) {
  const size_t n = (size_t)P * C * D;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float acc = 0.f;
  if (counts[idx / ((size_t)C * D)] > 0)
    for (int s = 0; s < S; ++s) acc += part[s * n + idx];
  y[idx] = acc;
}

struct SkinnyPlan {
  bool use = false;
  int s1 = 1, kc1 = 1;      // gate/up: splits of D and their length
  int s2 = 1, kc2 = 1;      // down: splits of F and their length
};

SkinnyPlan skinny_plan(int P, int C, int D, int F) {
  SkinnyPlan pl;
  pl.use = C <= 4 && D % V == 0 && F % V == 0;
  auto split = [&](int K, int N, int& S, int& kc) {
    const int colblocks = (N + V * SK_NT - 1) / (V * SK_NT);
    int s = (TARGET_BLOCKS + colblocks * P - 1) / (colblocks * P);
    s = std::max(1, std::min(s, (K + 31) / 32));
    kc = std::min((K + s - 1) / s, MAX_KCHUNK);
    S = (K + kc - 1) / kc;
  };
  split(D, F, pl.s1, pl.kc1);
  split(F, D, pl.s2, pl.kc2);
  return pl;
}

template <int BM>
cudaError_t launch_skinny(const SkinnyPlan& pl, const void* x,
                          const void* wg, const void* wu, const void* wd,
                          const int* se, const int* counts, float* ws,
                          void* y, int P, int C, int D, int F, int gated,
                          int act, cudaStream_t st) {
  float* hidden = ws;
  float* p0 = hidden + (size_t)P * C * F;
  float* p1 = p0 + (size_t)pl.s1 * P * C * F;
  float* p2 = p1 + (size_t)pl.s1 * P * C * F;
  const dim3 g1((F + V * SK_NT - 1) / (V * SK_NT), pl.s1, P);
  const size_t sm1 = (size_t)BM * pl.kc1 * sizeof(float);
  if (gated)
    skinny_partial_kernel<BM, true><<<g1, SK_NT, sm1, st>>>(
        (const float*)x, (const float*)wg, (const float*)wu, se, counts, p0,
        p1, P, C, D, F, pl.kc1);
  else
    skinny_partial_kernel<BM, false><<<g1, SK_NT, sm1, st>>>(
        (const float*)x, (const float*)wu, nullptr, se, counts, p0, nullptr,
        P, C, D, F, pl.kc1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t nh = (size_t)P * C * F;
  finalize_hidden_kernel<<<(unsigned)((nh + 255) / 256), 256, 0, st>>>(
      p0, p1, counts, hidden, P, C, F, pl.s1, gated, act);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 g2((D + V * SK_NT - 1) / (V * SK_NT), pl.s2, P);
  const size_t sm2 = (size_t)BM * pl.kc2 * sizeof(float);
  skinny_partial_kernel<BM, false><<<g2, SK_NT, sm2, st>>>(
      hidden, (const float*)wd, nullptr, se, counts, p2, nullptr, P, C, F, D,
      pl.kc2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t ny = (size_t)P * C * D;
  finalize_out_kernel<<<(unsigned)((ny + 255) / 256), 256, 0, st>>>(
      p2, counts, (float*)y, P, C, D, pl.s2);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tile path (prefill): one hidden column per thread, BM rows.
// ---------------------------------------------------------------------------

template <typename T, int BM>
cudaError_t launch_bm(const void* x, const void* wg, const void* wu,
                      const void* wd, const int* se, const int* counts,
                      float* hidden, void* y, int P, int C, int D, int F,
                      int gated, int act, cudaStream_t st) {
  const dim3 block(NT);
  const dim3 g1((F + NT - 1) / NT, (C + BM - 1) / BM, P);
  if (gated)
    moe_gate_up_kernel<T, BM, true><<<g1, block, 0, st>>>(
        (const T*)x, (const T*)wg, (const T*)wu, se, counts, hidden, C, D,
        F, act);
  else
    moe_gate_up_kernel<T, BM, false><<<g1, block, 0, st>>>(
        (const T*)x, (const T*)wu, (const T*)wu, se, counts, hidden, C, D,
        F, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 g2((D + NT - 1) / NT, (C + BM - 1) / BM, P);
  moe_down_kernel<T, BM><<<g2, block, 0, st>>>(hidden, (const T*)wd, se,
                                               counts, (T*)y, C, D, F);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tensor-core tile path (bf16: prefill and chunk calls at every C, decode
// steps at C > 8), on wgmma. Each consumer warpgroup owns a 64-row x
// 128-column output tile; a block of WM x WN warpgroups owns BM = 64 WM
// rows and BN = 128 WN columns of one slot. Small C (<= 64: one M tile)
// takes 1 x 2, so each weight row is read as 512 contiguous bytes; larger
// C takes 2 x 1, so two warpgroups share each weight tile. Operand tiles
// go through a ring of shared-memory stages filled by cp.async, STAGES -
// 2 tiles ahead of the multiply while one multiply stays in flight: at
// small C the path streams the slot's weights (bytes-bound) and needs
// many loads in flight; at large C the multiply is the limit. x (A) is
// K-major, the weights (B) MN-major, both in the canonical no-swizzle
// layout (sm90.cuh); rows past C and columns past D or F are zero-filled
// by the copies and never read from memory. Gate and up: both weight
// tiles sit in one stage and share the x tile; act(g) * u is taken in the
// accumulators' registers and stored in float32, [P, C, F]. Down: the
// float32 hidden tile is staged as it is and each thread splits its A
// fragment into hi = bf16(h) and lo = bf16(h - hi) in registers, two
// wgmma per k step on the same wd tile: hi + lo carries h to about 16
// significant bits and each product is exact in float32, so the result
// matches a float32 hidden @ bf16 wd to float32 summation order, where a
// single bf16 hidden would cost up to 2^-8 of each term. Every C uses the
// one instruction shape (m64n128k16) and the one k order, so a row's bits
// do not depend on C, on the block shape or on the rows beside it.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int WG_N = 128;                   // output columns per warpgroup

// stages of a ring in the shared memory a block may take (less 1 KB to
// align the ring to 1024 bytes), at most cap
constexpr int STAGES_FOR(int stage_bytes, int cap) {
  return (sm90::SMEM_MAX - 1024) / stage_bytes < cap
             ? (sm90::SMEM_MAX - 1024) / stage_bytes : cap;
}

// Tile shapes, chosen on the card: the streaming tiles (one M tile, small
// C) take deep k steps and a deep ring, the compute tiles (two M tiles)
// shorter ones.
template <int WM, int WN>
struct TcTile {
  static constexpr int NT = 128 * WM * WN, BM = 64 * WM, BN = WG_N * WN;
  static constexpr int BK_GU = WM == 1 ? 64 : 32;   // k depth per stage
  static constexpr int BK_DN = 64;
  static constexpr int CAP_GU = WM == 1 ? 8 : 4;    // at most this many stages
  static constexpr int CAP_DN = WM == 1 ? 8 : 4;
};

template <int WM, int WN, bool GATED>
struct GateUpCfg : TcTile<WM, WN> {
  using T = TcTile<WM, WN>;
  static constexpr int BK = T::BK_GU;
  static constexpr int A_BYTES = T::BM * BK * 2;
  static constexpr int B_BYTES = BK * T::BN * 2;
  static constexpr int STAGE_BYTES = A_BYTES + (GATED ? 2 : 1) * B_BYTES;
  static constexpr int STAGES = STAGES_FOR(STAGE_BYTES, T::CAP_GU);
  static_assert(STAGES >= 3, "one load ahead and one multiply in flight");
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024;  // + alignment
};

template <int WM, int WN>
struct DownCfg : TcTile<WM, WN> {
  using T = TcTile<WM, WN>;
  static constexpr int BK = T::BK_DN;
  static constexpr int PITCH = BK + 8;      // floats per staged hidden row
  static constexpr int A_BYTES = (T::BM * PITCH * 4 + 1023) / 1024 * 1024;
  static constexpr int B_BYTES = BK * T::BN * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGES = STAGES_FOR(STAGE_BYTES, T::CAP_DN);
  static_assert(STAGES >= 3, "one load ahead and one multiply in flight");
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024;  // + alignment
};

template <bool GATED, int WM, int WN>
__global__ void __launch_bounds__(128 * WM * WN, 1)
moe_gate_up_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wg,
                      const bf16* __restrict__ wu,
                      const int* __restrict__ slot_expert,
                      const int* __restrict__ counts,
                      float* __restrict__ hidden, int C, int D, int F,
                      int act) {
  using Cfg = GateUpCfg<WM, WN, GATED>;
  constexpr int NT = Cfg::NT, BK = Cfg::BK, BN = Cfg::BN;
  constexpr int STAGES = Cfg::STAGES;
  extern __shared__ __align__(1024) char smem_raw[];
  char* smem = sm90::align1024(smem_raw);
  const int p = blockIdx.z;
  if (counts[p] <= 0) return;                   // block-uniform
  const int e = max(slot_expert[p], 0);
  const int m0 = blockIdx.x * Cfg::BM;
  const int n0 = blockIdx.y * BN;
  const bf16* xp = x + (size_t)p * C * D;
  const bf16* wgp = wg + (size_t)e * D * F;
  const bf16* wup = wu + (size_t)e * D * F;
  const int nk = (D + BK - 1) / BK;

  auto load = [&](int s, int kt) {
    char* st = smem + s * Cfg::STAGE_BYTES;
    const int k0 = kt * BK;
    sm90::stage_tile<Cfg::BM, BK, NT>(
        reinterpret_cast<bf16*>(st), [&](int r, int cg, bool& ok) {
          const int row = m0 + r, k = k0 + cg * 8;
          ok = row < C && k < D;
          return xp + (ok ? (size_t)row * D + k : 0);
        });
    auto wsrc = [&](const bf16* w) {
      return [=](int r, int cg, bool& ok) {
        const int k = k0 + r, n = n0 + cg * 8;
        ok = k < D && n < F;
        return w + (ok ? (size_t)k * F + n : 0);
      };
    };
    sm90::stage_tile_sw128<BK, BN, NT>(
        reinterpret_cast<bf16*>(st + Cfg::A_BYTES), wsrc(wup));
    if (GATED)
      sm90::stage_tile_sw128<BK, BN, NT>(
          reinterpret_cast<bf16*>(st + Cfg::A_BYTES + Cfg::B_BYTES),
          wsrc(wgp));
  };
#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < nk) load(s, s);
    sm90::cp_async_commit();
  }

  // this warpgroup's rows wm * 64.. and columns wn * 128.. of the block
  const int w = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int wm = w / WN, wn = w % WN;
  float au[WG_N / 2], ag[GATED ? WG_N / 2 : 1];
#pragma unroll
  for (int i = 0; i < WG_N / 2; ++i) au[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (GATED ? WG_N / 2 : 1); ++i) ag[i] = 0.f;
  // one multiply stays in flight across the barrier: tile kt's wgmma runs
  // while tile kt + 1 is waited for, and stage (kt - 2) % STAGES, whose
  // multiply every warpgroup has waited for, takes the next load
  for (int kt = 0; kt < nk; ++kt) {
    sm90::cp_async_wait<STAGES - 3>();
    sm90::fence_proxy_async();
    __syncthreads();                            // tile kt landed
    if (kt + STAGES - 2 < nk) load((kt + STAGES - 2) % STAGES, kt + STAGES - 2);
    sm90::cp_async_commit();
    const char* st = smem + (kt % STAGES) * Cfg::STAGE_BYTES;
    const uint64_t da = sm90::desc(st + wm * 64 * BK * 2, 128, BK * 16);
    // this warpgroup's two 64-column atoms of each weight tile
    const char* bu = st + Cfg::A_BYTES + wn * 2 * BK * 128;
    const uint64_t du = sm90::desc_sw128(bu, BK * 128);
    const uint64_t dg = sm90::desc_sw128(bu + Cfg::B_BYTES, BK * 128);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      sm90::wgmma_ss_n128(au, da + kk * 16, du + kk * (2048 >> 4), 1);
      if constexpr (GATED)
        sm90::wgmma_ss_n128(ag, da + kk * 16, dg + kk * (2048 >> 4), 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();                      // tile kt - 1's multiply
  }
  sm90::wgmma_wait<0>();
  sm90::pin(au);
  sm90::pin(ag);
  sm90::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < WG_N / 2; i += 2) {
    const int row = m0 + wm * 64 + sm90::frag_row(t, i);
    const int col = n0 + wn * WG_N + sm90::frag_col(t, i);
    if (row < C && col < F) {
      float2 h;
      if constexpr (GATED) {
        h.x = act_fn(ag[i], act) * au[i];
        h.y = act_fn(ag[i + 1], act) * au[i + 1];
      } else {
        h.x = act_fn(au[i], act);
        h.y = act_fn(au[i + 1], act);
      }
      *reinterpret_cast<float2*>(hidden + ((size_t)p * C + row) * F + col) =
          h;
    }
  }
}

template <int WM, int WN>
__global__ void __launch_bounds__(128 * WM * WN, 1)
moe_down_tc_kernel(const float* __restrict__ hidden,
                   const bf16* __restrict__ wd,
                   const int* __restrict__ slot_expert,
                   const int* __restrict__ counts, bf16* __restrict__ y,
                   int C, int D, int F) {
  using Cfg = DownCfg<WM, WN>;
  constexpr int NT = Cfg::NT, BK = Cfg::BK, BN = Cfg::BN;
  constexpr int STAGES = Cfg::STAGES;
  extern __shared__ __align__(1024) char smem_raw[];
  char* smem = sm90::align1024(smem_raw);
  const int p = blockIdx.z;
  const int m0 = blockIdx.x * Cfg::BM;
  const int n0 = blockIdx.y * BN;
  if (counts[p] <= 0) {                         // block-uniform
    for (int idx = threadIdx.x; idx < Cfg::BM * BN; idx += NT) {
      const int r = idx / BN, c = idx % BN;
      if (m0 + r < C && n0 + c < D)
        y[((size_t)p * C + m0 + r) * D + n0 + c] = __float2bfloat16(0.f);
    }
    return;
  }
  const int e = max(slot_expert[p], 0);
  const float* hp = hidden + (size_t)p * C * F;
  const bf16* wdp = wd + (size_t)e * F * D;
  const int nk = (F + BK - 1) / BK;

  auto load = [&](int s, int kt) {
    char* st = smem + s * Cfg::STAGE_BYTES;
    const int k0 = kt * BK;
    float* as = reinterpret_cast<float*>(st);
    for (int c = threadIdx.x; c < Cfg::BM * BK / 4; c += NT) {
      const int r = c / (BK / 4), k = (c % (BK / 4)) * 4;
      const bool ok = m0 + r < C && k0 + k < F;
      sm90::cp_async16(as + r * Cfg::PITCH + k,
                       hp + (ok ? (size_t)(m0 + r) * F + k0 + k : 0), ok);
    }
    sm90::stage_tile_sw128<BK, BN, NT>(
        reinterpret_cast<bf16*>(st + Cfg::A_BYTES),
        [&](int r, int cg, bool& ok) {
          const int k = k0 + r, n = n0 + cg * 8;
          ok = k < F && n < D;
          return wdp + (ok ? (size_t)k * D + n : 0);
        });
  };
#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < nk) load(s, s);
    sm90::cp_async_commit();
  }

  const int w = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int wm = w / WN, wn = w % WN;
  const int ra = wm * 64 + sm90::frag_row(t, 0), rb = ra + 8;
  float acc[WG_N / 2];
#pragma unroll
  for (int i = 0; i < WG_N / 2; ++i) acc[i] = 0.f;
  using Frag = uint32_t[BK / 16][4];
  // one k step: wait for its tile, split this thread's A fragments into
  // hi and lo (into the buffer the multiply of kt - 2 read, which is done)
  // and issue its multiply; the multiply of kt - 1 is then waited for, and
  // its buffer (prev) pinned, so the compiler keeps the two buffers apart
  // while a multiply reads one
  auto step = [&](int kt, Frag& hi, Frag& lo, Frag& hi_prev, Frag& lo_prev) {
    sm90::cp_async_wait<STAGES - 3>();
    sm90::fence_proxy_async();
    __syncthreads();                            // tile kt landed
    if (kt + STAGES - 2 < nk) load((kt + STAGES - 2) % STAGES, kt + STAGES - 2);
    sm90::cp_async_commit();
    const char* st = smem + (kt % STAGES) * Cfg::STAGE_BYTES;
    const float* as = reinterpret_cast<const float*>(st);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const int c = kk * 16 + (t & 3) * 2;
      const float2 v[4] = {
          *reinterpret_cast<const float2*>(as + ra * Cfg::PITCH + c),
          *reinterpret_cast<const float2*>(as + rb * Cfg::PITCH + c),
          *reinterpret_cast<const float2*>(as + ra * Cfg::PITCH + c + 8),
          *reinterpret_cast<const float2*>(as + rb * Cfg::PITCH + c + 8)};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bf16 hx = __float2bfloat16(v[j].x), hy = __float2bfloat16(v[j].y);
        hi[kk][j] = sm90::pack_bf16(__bfloat162float(hx),
                                    __bfloat162float(hy));
        lo[kk][j] = sm90::pack_bf16(v[j].x - __bfloat162float(hx),
                                    v[j].y - __bfloat162float(hy));
      }
    }
    const uint64_t db =
        sm90::desc_sw128(st + Cfg::A_BYTES + wn * 2 * BK * 128, BK * 128);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      sm90::wgmma_rs(acc, hi[kk], db + kk * (2048 >> 4), 1);
      sm90::wgmma_rs(acc, lo[kk], db + kk * (2048 >> 4), 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();                      // tile kt - 1's multiply
    sm90::pin(hi_prev);
    sm90::pin(lo_prev);
  };
  // two fragment buffers, so no register a multiply in flight reads is
  // written before it is waited for
  Frag hi0, lo0, hi1 = {}, lo1 = {};
#pragma unroll 1
  for (int kt = 0; kt < nk; kt += 2) {
    step(kt, hi0, lo0, hi1, lo1);
    if (kt + 1 < nk) step(kt + 1, hi1, lo1, hi0, lo0);
  }
  sm90::wgmma_wait<0>();
  sm90::pin(acc);
  sm90::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < WG_N / 2; i += 2) {
    const int row = m0 + wm * 64 + sm90::frag_row(t, i);
    const int col = n0 + wn * WG_N + sm90::frag_col(t, i);
    if (row < C && col < D)
      *reinterpret_cast<uint32_t*>(y + ((size_t)p * C + row) * D + col) =
          sm90::pack_bf16(acc[i], acc[i + 1]);
  }
}

// Raise a kernel's dynamic shared-memory limit once, then launch it.
template <typename Kernel, typename... Args>
cudaError_t launch_big(Kernel kernel, bool& sized, dim3 grid, int nt,
                       int smem, cudaStream_t st, Args... args) {
  const cudaError_t err = sm90::allow_smem(kernel, sized);
  if (err != cudaSuccess) return err;
  kernel<<<grid, nt, smem, st>>>(args...);
  return cudaGetLastError();
}

template <int WM, int WN>
cudaError_t launch_gate_up(const void* x, const void* wg, const void* wu,
                           const int* se, const int* counts, float* hidden,
                           int P, int C, int D, int F, int gated, int act,
                           cudaStream_t st) {
  using Tile = TcTile<WM, WN>;
  static bool sized[2];
  const dim3 grid((C + Tile::BM - 1) / Tile::BM, (F + Tile::BN - 1) / Tile::BN,
                  P);
  if (gated)
    return launch_big(moe_gate_up_tc_kernel<true, WM, WN>, sized[0], grid,
                      Tile::NT, GateUpCfg<WM, WN, true>::SMEM, st,
                      (const bf16*)x, (const bf16*)wg, (const bf16*)wu, se,
                      counts, hidden, C, D, F, act);
  return launch_big(moe_gate_up_tc_kernel<false, WM, WN>, sized[1], grid,
                    Tile::NT, GateUpCfg<WM, WN, false>::SMEM, st,
                    (const bf16*)x, (const bf16*)wu, (const bf16*)wu, se,
                    counts, hidden, C, D, F, act);
}

template <int WM, int WN>
cudaError_t launch_down(const float* hidden, const void* wd, const int* se,
                        const int* counts, void* y, int P, int C, int D,
                        int F, cudaStream_t st) {
  using Tile = TcTile<WM, WN>;
  static bool sized;
  const dim3 grid((C + Tile::BM - 1) / Tile::BM, (D + Tile::BN - 1) / Tile::BN,
                  P);
  return launch_big(moe_down_tc_kernel<WM, WN>, sized, grid, Tile::NT,
                    DownCfg<WM, WN>::SMEM, st, hidden, (const bf16*)wd, se,
                    counts, (bf16*)y, C, D, F);
}

cudaError_t launch_tc(const void* x, const void* wg, const void* wu,
                      const void* wd, const int* se, const int* counts,
                      float* hidden, void* y, int P, int C, int D, int F,
                      int gated, int act, cudaStream_t st) {
  const bool small = C <= 64;
  cudaError_t err =
      small ? launch_gate_up<1, 2>(x, wg, wu, se, counts, hidden, P, C, D, F,
                                   gated, act, st)
            : launch_gate_up<2, 1>(x, wg, wu, se, counts, hidden, P, C, D, F,
                                   gated, act, st);
  if (err != cudaSuccess) return err;
  return small ? launch_down<1, 2>(hidden, wd, se, counts, y, P, C, D, F, st)
               : launch_down<2, 2>(hidden, wd, se, counts, y, P, C, D, F, st);
}

bool tc_shapes_ok(int D, int F) { return D % 8 == 0 && F % 8 == 0; }

// ---------------------------------------------------------------------------
// Decode path (bf16 decode steps at C <= 8): bytes-bound weight streaming
// on the tensor cores. Two persistent launches over the live slots only,
// each block (one warpgroup) walking a fixed share of the work items (it
// reads counts itself: empty slots launch nothing):
//   gate/up, one block an SM: an item is (live slot, 128 columns of F),
//     the whole of D, so act(g) * u is taken in the accumulators'
//     registers and the float32 hidden is written once (no split of D, no
//     partials);
//   down, two blocks an SM: an item is (live slot, 128 columns of D), the
//     whole of F: 256 items at Mixtral's widths, so no split of F either
//     (nothing to merge); the float32 hidden is split into hi + lo bf16
//     rows as it lands, so y matches a float32 hidden @ bf16 wd to
//     float32 summation order (the tensor-core path's rule). One block an
//     SM streamed slower here: it converts the hidden and multiplies every
//     16 KB weight tile, where gate/up multiplies every 32 KB; a second
//     block on the SM hides that.
// The product is the swapped one, y^T = W^T x^T: wgmma with a 64-column
// weight tile as the MN-major A operand (128-byte swizzle, a warp reads
// 256 contiguous bytes of a weight row) and the tokens, C padded to 8 with
// zero rows, as the K-major B operand (m64n8k16; for down m64n16k16, the
// hi rows then the lo rows, so each weight tile is read once and a token's
// hi and lo sums are added at the end), float32 accumulators: the tensor
// cores take the FMA work, which at C 8 would hold the CUDA cores for
// about 40% of the byte time (22.5 GFLOP a call at Mixtral's widths
// against 67 TFLOP/s, before the bf16 conversions).
// Weight tiles (64 rows of k) and the tokens' k slice go through one ring
// of shared-memory stages, STAGES - 2 ahead: one thread issues the weight
// tiles as TMA copies (a 64-column box an atom, from a tensor map of the
// bank made once per bank, 128-byte swizzled by the copy, zero past the
// matrix) that complete on the stage's mbarrier, and every thread copies
// its 16 bytes of the token (or hidden) slice by cp.async. The ring runs
// on across a block's items, so the stream does not drain between them. The down pass is a programmatic dependent launch
// (the overlap chosen over one persistent launch, whose down items would
// have to wait on other blocks' gate/up items): the gate/up blocks let it
// start at once, its blocks take SMs as gate/up blocks finish and fill
// their ring with wd tiles, and only the hidden's loads wait for the
// gate/up grid (griddepcontrol.wait). Every C from 1 to 8 takes the one
// instruction shape and the one k order, and nothing depends on P,
// counts, the SM count or which block takes an item: a row's bits depend
// only on its own x and its slot's expert (a shadow slot gives its
// primary's bits). No atomics, no scratch beyond the hidden, no host sync
// (capturable in a CUDA graph).
// ---------------------------------------------------------------------------

namespace dec {
constexpr int NT = 128;                  // one consumer warpgroup
constexpr int N = 8;                     // tokens a product takes (wgmma N)
constexpr int COLS = 128;                // weight columns of an item
constexpr int ATOMS = COLS / 64;         // 64-column A operands an item
constexpr int BK = 64;                   // weight rows (k) a ring stage
constexpr int W_BYTES = BK * COLS * 2;   // one weight tile, 16 KB
constexpr int X_BYTES = N * BK * 2;      // 8 token rows' k slice, 1 KB
// slots the live list holds: Kimi-K2 on 2 EWs has 384 primary and 384
// shadow slots; 4 bytes a slot of dynamic shared memory, which leaves every
// ring's stage count as it was at 512
constexpr int MAX_P = 1024;
constexpr int LIVE_BYTES = MAX_P * 4 + 16 * 8;  // live list, mbarriers
constexpr int SM_SMEM = 233472;          // shared memory of an SM, 228 KB

constexpr int round1024(int bytes) { return (bytes + 1023) / 1024 * 1024; }

// shared memory a block may take when `blocks` blocks share an SM (each
// less 1 KB for the system)
constexpr int block_smem(int blocks) {
  return SM_SMEM / blocks - 1024 < sm90::SMEM_MAX ? SM_SMEM / blocks - 1024
                                                  : sm90::SMEM_MAX;
}

// stages of a ring that fit beside the live list and 1 KB to align the
// ring to 1024 bytes, at most cap
constexpr int ring_stages(int stage_bytes, int blocks, int cap) {
  return (block_smem(blocks) - 1024 - LIVE_BYTES) / stage_bytes < cap
             ? (block_smem(blocks) - 1024 - LIVE_BYTES) / stage_bytes
             : cap;
}

// gate/up, one block an SM: [wu tile][wg tile][x slice] a stage
template <bool GATED>
struct GateUp {
  static constexpr int BLOCKS_PER_SM = 1;
  static constexpr int STAGE =
      round1024((GATED ? 2 : 1) * W_BYTES + X_BYTES);
  static constexpr int STAGES = ring_stages(STAGE, BLOCKS_PER_SM, 8);
  static_assert(STAGES >= 3, "one load ahead and one multiply in flight");
  // the ring, the live list after it, and 1024 bytes to align the ring
  static constexpr int SMEM = STAGES * STAGE + LIVE_BYTES + 1024;
};

// down, two blocks an SM (one warpgroup alone streams slower: it converts
// the hidden and multiplies every 16 KB weight tile):
// [wd tile][hidden slice, float32][hi slice][lo slice] a stage
struct Down {
  static constexpr int BLOCKS_PER_SM = 2;
  static constexpr int RAW_BYTES = N * BK * 4;
  static constexpr int STAGE = round1024(W_BYTES + RAW_BYTES + 2 * X_BYTES);
  static constexpr int STAGES = ring_stages(STAGE, BLOCKS_PER_SM, 10);
  static_assert(STAGES >= 3, "one load ahead and one multiply in flight");
  static constexpr int SMEM = STAGES * STAGE + LIVE_BYTES + 1024;
};

// The live slots (counts > 0) in slot order, into live[]; their number.
__device__ __forceinline__ int live_slots(const int* __restrict__ counts,
                                          int P, int* live) {
  __shared__ int n_live;
  if (threadIdx.x < 32) {
    int n = 0;
    for (int base = 0; base < P; base += 32) {
      const int p = base + threadIdx.x;
      const bool on = p < P && counts[p] > 0;
      const unsigned m = __ballot_sync(0xffffffffu, on);
      if (on) live[n + __popc(m & ((1u << threadIdx.x) - 1))] = p;
      n += __popc(m);
    }
    if (threadIdx.x == 0) n_live = n;
  }
  __syncthreads();
  return n_live;
}

// Descriptors of a stage's operands: atom a (64 columns) of a weight tile
// at k step kk, and k step kk of a [8 x BK] token slice (of 16 rows: its
// next 8 follow at BK * 16 bytes).
__device__ __forceinline__ uint64_t wdesc(const char* tile, int a, int kk) {
  return sm90::desc_sw128(tile + a * BK * 128 + kk * 2048, BK * 128);
}
__device__ __forceinline__ uint64_t xdesc(const char* slice, int kk) {
  return sm90::desc(slice + kk * 256, 128, BK * 16);
}

// Issue (one thread) the TMA copies of a weight tile: rows k0.. k0 + BK
// of expert e's matrix in the tensor map, columns n0..n0 + COLS, one box a
// 64-column atom (zero-filled past the matrix), completing on bar.
__device__ __forceinline__ void load_weights(char* dst, const CUtensorMap* tm,
                                             uint64_t* bar, int e, int k0,
                                             int n0) {
#pragma unroll
  for (int a = 0; a < ATOMS; ++a)
    sm90::tma_load_3d(dst + a * BK * 128, tm, bar, n0 + a * 64, k0, e);
}

// The ring's full barriers (one a stage) after the live list; thread 0
// initialises them (one arrival each: the thread that issues the copies).
template <int STAGES>
__device__ __forceinline__ uint64_t* ring_barriers(int* live) {
  uint64_t* full = reinterpret_cast<uint64_t*>(live + MAX_P);
  static_assert(STAGES <= 16, "barrier space");
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) sm90::mbar_init(&full[s], 1);
    sm90::fence_mbar_init();
  }
  return full;
}

template <bool GATED>
__global__ void __launch_bounds__(NT, GateUp<GATED>::BLOCKS_PER_SM)
moe_decode_gate_up_kernel(const bf16* __restrict__ x,
                          const __grid_constant__ CUtensorMap tm_g,
                          const __grid_constant__ CUtensorMap tm_u,
                          const int* __restrict__ slot_expert,
                          const int* __restrict__ counts,
                          float* __restrict__ hidden, int P, int C, int D,
                          int F, int act) {
  using Cfg = GateUp<GATED>;
  constexpr int STAGES = Cfg::STAGES;
  constexpr int XOFF = (GATED ? 2 : 1) * W_BYTES;
  extern __shared__ __align__(1024) char smem_raw[];
  char* smem = sm90::align1024(smem_raw);
  int* live = reinterpret_cast<int*>(smem + STAGES * Cfg::STAGE);
  uint64_t* full = ring_barriers<STAGES>(live);   // (live_slots syncs)
  sm90::griddep_launch_dependents();   // the down pass may take freed SMs
  const int nft = (F + COLS - 1) / COLS;          // column tiles a slot
  const int nk = (D + BK - 1) / BK;               // k tiles an item
  const int items = live_slots(counts, P, live) * nft;
  const int mine = items > (int)blockIdx.x
                       ? (items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                       : 0;
  const int total = mine * nk;                    // this block's k tiles
  // the k tile g of this block's walk: item blockIdx.x + (g / nk) *
  // gridDim.x, its tile g % nk
  auto item = [&](int g) { return (int)blockIdx.x + g / nk * (int)gridDim.x; };
  auto load = [&](int s, int g) {
    const int it = item(g), p = live[it / nft];
    const int e = max(slot_expert[p], 0);
    const int k0 = (g % nk) * BK, n0 = (it % nft) * COLS;
    char* st = smem + s * Cfg::STAGE;
    if (threadIdx.x == 0) {
      sm90::mbar_arrive_expect_tx(&full[s], (GATED ? 2 : 1) * W_BYTES);
      load_weights(st, &tm_u, &full[s], e, k0, n0);
      if (GATED) load_weights(st + W_BYTES, &tm_g, &full[s], e, k0, n0);
    }
    const bf16* xp = x + (size_t)p * C * D;
    sm90::stage_tile<N, BK, NT>(
        reinterpret_cast<bf16*>(st + XOFF), [&](int r, int cg, bool& ok) {
          const int k = k0 + cg * 8;
          ok = r < C && k < D;
          return xp + (ok ? (size_t)r * D + k : 0);
        });
  };
#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < total) load(s, s);
    sm90::cp_async_commit();
  }

  const int t = threadIdx.x;
  float au[ATOMS][4] = {}, ag[ATOMS][4] = {};
  for (int g = 0; g < total; ++g) {
    sm90::cp_async_wait<STAGES - 3>();            // this thread's x slice
    sm90::mbar_wait(&full[g % STAGES], (g / STAGES) & 1);  // the weights
    sm90::fence_proxy_async();
    __syncthreads();                              // tile g landed
    if (g + STAGES - 2 < total) load((g + STAGES - 2) % STAGES, g + STAGES - 2);
    sm90::cp_async_commit();
    const char* st = smem + (g % STAGES) * Cfg::STAGE;
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dx = xdesc(st + XOFF, kk);
#pragma unroll
      for (int a = 0; a < ATOMS; ++a) {
        sm90::wgmma_ss_n8_mn_a(au[a], wdesc(st, a, kk), dx, 1);
        if constexpr (GATED)
          sm90::wgmma_ss_n8_mn_a(ag[a], wdesc(st + W_BYTES, a, kk), dx, 1);
      }
    }
    sm90::wgmma_commit();
    if (g % nk != nk - 1) {
      sm90::wgmma_wait<1>();                      // tile g - 1's multiply
      continue;
    }
    // the item's last tile: act(g) * u in float32, into the hidden
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int a = 0; a < ATOMS; ++a) {
      sm90::pin(au[a]);
      sm90::pin(ag[a]);
    }
    const int it = item(g), p = live[it / nft];
    const int n0 = (it % nft) * COLS;
#pragma unroll
    for (int a = 0; a < ATOMS; ++a)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int f = n0 + a * 64 + sm90::frag_row(t, i);
        const int m = sm90::frag_col(t, i);
        if (m < C && f < F)
          hidden[((size_t)p * C + m) * F + f] =
              GATED ? act_fn(ag[a][i], act) * au[a][i] : act_fn(au[a][i], act);
        au[a][i] = ag[a][i] = 0.f;
      }
  }
  sm90::cp_async_wait<0>();
}

__global__ void __launch_bounds__(NT, Down::BLOCKS_PER_SM)
moe_decode_down_kernel(const float* __restrict__ hidden,
                       const __grid_constant__ CUtensorMap tm_d,
                       const int* __restrict__ slot_expert,
                       const int* __restrict__ counts, bf16* __restrict__ y,
                       int P, int C, int D, int F) {
  using Cfg = Down;
  constexpr int STAGES = Cfg::STAGES;
  constexpr int RAW = W_BYTES, HI = RAW + Cfg::RAW_BYTES, LO = HI + X_BYTES;
  static_assert(LO - HI == BK * 16, "lo rows 8-15 of the hi slice's B");
  extern __shared__ __align__(1024) char smem_raw[];
  char* smem = sm90::align1024(smem_raw);
  int* live = reinterpret_cast<int*>(smem + STAGES * Cfg::STAGE);
  uint64_t* full = ring_barriers<STAGES>(live);   // (live_slots syncs)
  const int t = threadIdx.x;
  // empty slots give 0: this pass alone writes y, so before the wait
  {
    const size_t per = (size_t)C * D / 8;         // 16-byte vectors a slot
    for (size_t v = (size_t)blockIdx.x * NT + t; v < (size_t)P * per;
         v += (size_t)gridDim.x * NT)
      if (counts[v / per] <= 0)
        reinterpret_cast<uint4*>(y)[v] = make_uint4(0, 0, 0, 0);
  }
  const int ndt = (D + COLS - 1) / COLS;          // column tiles a slot
  const int nk = (F + BK - 1) / BK;               // k tiles an item
  const int items = live_slots(counts, P, live) * ndt;
  const int mine = items > (int)blockIdx.x
                       ? (items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                       : 0;
  const int total = mine * nk;
  auto item = [&](int g) { return (int)blockIdx.x + g / nk * (int)gridDim.x; };
  auto load_w = [&](int s, int g) {
    if (threadIdx.x != 0) return;
    const int it = item(g), p = live[it / ndt];
    const int e = max(slot_expert[p], 0);
    sm90::mbar_arrive_expect_tx(&full[s], W_BYTES);
    load_weights(smem + s * Cfg::STAGE, &tm_d, &full[s], e, (g % nk) * BK,
                 (it % ndt) * COLS);
  };
  // the hidden's k slice, [8 rows][BK] floats, in 16-byte chunks: thread
  // t copies (and later splits) chunks t, t + NT, ...: row q / (BK / 4),
  // k (q % (BK / 4)) * 4
  constexpr int HCH = N * BK / 4;
  auto load_h = [&](int s, int g) {
    const int p = live[item(g) / ndt];
#pragma unroll
    for (int q = t; q < HCH; q += NT) {
      const int hm = q / (BK / 4), hk = (q % (BK / 4)) * 4;
      const int k = (g % nk) * BK + hk;
      const bool ok = hm < C && k < F;
      sm90::cp_async16(smem + s * Cfg::STAGE + RAW + q * 16,
                       hidden + (ok ? ((size_t)p * C + hm) * F + k : 0), ok);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < total) load_w(s, s);
    sm90::cp_async_commit();
  }
  sm90::griddep_wait();                           // the hidden is complete
  for (int s = 0; s < STAGES - 2 && s < total; ++s) load_h(s, s);
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();

  // per atom, columns 0-7 sum the hi products, 8-15 the lo ones
  float acc[ATOMS][8] = {};
  for (int g = 0; g < total; ++g) {
    sm90::cp_async_wait<STAGES - 3>();            // this thread's hidden
    sm90::mbar_wait(&full[g % STAGES], (g / STAGES) & 1);  // the weights
    char* st = smem + (g % STAGES) * Cfg::STAGE;
#pragma unroll
    for (int q = t; q < HCH; q += NT) {
      // this thread's 4 hidden values of tile g: hi = bf16(h), lo =
      // bf16(h - hi), into the K-major core matrices of the hi and lo
      // slices (core matrix hk / 8, row hm)
      const int hm = q / (BK / 4), hk = (q % (BK / 4)) * 4;
      const float4 v = *reinterpret_cast<const float4*>(st + RAW + q * 16);
      const float h[4] = {v.x, v.y, v.z, v.w};
      float hi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        hi[j] = __bfloat162float(__float2bfloat16(h[j]));
      const int off = (hk >> 3) * 128 + hm * 16 + (hk & 7) * 2;
      *reinterpret_cast<uint2*>(st + HI + off) = make_uint2(
          sm90::pack_bf16(hi[0], hi[1]), sm90::pack_bf16(hi[2], hi[3]));
      *reinterpret_cast<uint2*>(st + LO + off) = make_uint2(
          sm90::pack_bf16(h[0] - hi[0], h[1] - hi[1]),
          sm90::pack_bf16(h[2] - hi[2], h[3] - hi[3]));
    }
    sm90::fence_proxy_async();
    __syncthreads();                              // tile g landed and split
    if (g + STAGES - 2 < total) {
      load_w((g + STAGES - 2) % STAGES, g + STAGES - 2);
      load_h((g + STAGES - 2) % STAGES, g + STAGES - 2);
    }
    sm90::cp_async_commit();
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // the lo slice follows the hi slice: one B operand of 16 rows
      const uint64_t dh = xdesc(st + HI, kk);
#pragma unroll
      for (int a = 0; a < ATOMS; ++a)
        sm90::wgmma_ss_n16_mn_a(acc[a], wdesc(st, a, kk), dh, 1);
    }
    sm90::wgmma_commit();
    if (g % nk != nk - 1) {
      sm90::wgmma_wait<1>();
      continue;
    }
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int a = 0; a < ATOMS; ++a) sm90::pin(acc[a]);
    const int it = item(g), p = live[it / ndt];
    const int n0 = (it % ndt) * COLS;
#pragma unroll
    for (int a = 0; a < ATOMS; ++a)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = n0 + a * 64 + sm90::frag_row(t, i);
        const int m = sm90::frag_col(t, i);
        if (m < C && d < D)
          y[((size_t)p * C + m) * D + d] =
              __float2bfloat16(acc[a][i] + acc[a][i + 4]);
        acc[a][i] = acc[a][i + 4] = 0.f;
      }
  }
  sm90::cp_async_wait<0>();
}

}  // namespace dec

bool decode_shapes_ok(int P, int C, int D, int F) {
  return C <= dec::N && P <= dec::MAX_P && D % 8 == 0 && F % 8 == 0;
}

// SMs of the current device (asked once per device)
cudaError_t sm_count(int* n) {
  static int count[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (count[dev] == 0 &&
      (err = cudaDeviceGetAttribute(&count[dev],
                                    cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess)
    return err;
  *n = count[dev];
  return cudaSuccess;
}

// The tensor map of one expert bank [E][K][Nw] in the decode path's
// boxes, made once per (bank, K, Nw) and kept: a map is host work, and an
// eager decode step is host-bound. The cache holds MAPS maps, three a MoE
// layer, replaced in turn when full: 256 keep every bank of a whole
// Qwen1.5-MoE-A2.7B (72), Mixtral-8x7B (96) or Kimi-K2 (180), where 64
// made a 24-layer model encode every map again at every step. E is not
// passed to the kernel's entry, so the map spans as many experts as a
// tensor map may (a box only ever reads an expert of slot_expert, which
// the bank holds; the offsets are the map's, 64-bit).
constexpr int MAPS = 256;
long long maps_encoded = 0;          // tensor maps made since the load

cudaError_t tensor_map(CUtensorMap* out, const void* w, int K, int Nw) {
  struct Key {
    const void* w;
    int K, Nw;
  };
  static Key keys[MAPS];
  static CUtensorMap maps[MAPS];
  static int next = 0;
  for (int i = 0; i < MAPS; ++i)
    if (keys[i].w == w && keys[i].K == K && keys[i].Nw == Nw) {
      *out = maps[i];
      return cudaSuccess;
    }
  const cudaError_t err =
      sm90::make_tma_3d(&maps[next], w, 1 << 16, K, Nw, dec::BK);
  if (err != cudaSuccess) return err;
  ++maps_encoded;
  keys[next] = Key{w, K, Nw};
  *out = maps[next];
  next = (next + 1) % MAPS;
  return cudaSuccess;
}

cudaError_t launch_decode(const void* x, const void* wg, const void* wu,
                          const void* wd, const int* se, const int* counts,
                          float* hidden, void* y, int P, int C, int D, int F,
                          int gated, int act, cudaStream_t st) {
  using GU = dec::GateUp<true>;
  using GU1 = dec::GateUp<false>;
  using DN = dec::Down;
  static bool sized[3];
  CUtensorMap tm_g, tm_u, tm_d;
  cudaError_t err;
  if ((err = tensor_map(&tm_u, wu, D, F)) != cudaSuccess ||
      (err = tensor_map(&tm_g, gated ? wg : wu, D, F)) != cudaSuccess ||
      (err = tensor_map(&tm_d, wd, F, D)) != cudaSuccess)
    return err;
  int sms = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return err;
  const int gu_items = P * ((F + dec::COLS - 1) / dec::COLS);
  const int dn_items = P * ((D + dec::COLS - 1) / dec::COLS);
  if ((err = sm90::allow_smem(dec::moe_decode_gate_up_kernel<true>,
                              sized[0])) != cudaSuccess ||
      (err = sm90::allow_smem(dec::moe_decode_gate_up_kernel<false>,
                              sized[1])) != cudaSuccess ||
      (err = sm90::allow_smem(dec::moe_decode_down_kernel, sized[2])) !=
          cudaSuccess)
    return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(std::min(GU::BLOCKS_PER_SM * sms, gu_items));
  cfg.blockDim = dim3(dec::NT);
  cfg.dynamicSmemBytes = gated ? GU::SMEM : GU1::SMEM;
  cfg.stream = st;
  err = gated ? cudaLaunchKernelEx(&cfg, dec::moe_decode_gate_up_kernel<true>,
                                   (const bf16*)x, tm_g, tm_u, se, counts,
                                   hidden, P, C, D, F, act)
              : cudaLaunchKernelEx(&cfg, dec::moe_decode_gate_up_kernel<false>,
                                   (const bf16*)x, tm_g, tm_u, se, counts,
                                   hidden, P, C, D, F, act);
  if (err != cudaSuccess) return err;
  // the down pass, a programmatic dependent launch of the gate/up pass
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.gridDim = dim3(std::min(DN::BLOCKS_PER_SM * sms, dn_items));
  cfg.dynamicSmemBytes = DN::SMEM;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, dec::moe_decode_down_kernel,
                           (const float*)hidden, tm_d, se, counts, (bf16*)y, P,
                           C, D, F);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// float32 workspace the launch needs: the hidden activation, plus the
// split partials on the float32 skinny path
template <typename T>
size_t workspace_floats(int P, int C, int D, int F, int decode) {
  size_t need = (size_t)P * C * F;
  if (std::is_same<T, float>::value && decode) {
    const SkinnyPlan pl = skinny_plan(P, C, D, F);
    if (pl.use)
      need += 2 * (size_t)pl.s1 * P * C * F + (size_t)pl.s2 * P * C * D;
  }
  return need;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

enum Path { SKINNY = 0, TENSOR_CORE = 1, CUDA_CORE = 2 };

// SKINNY is the decode path: the float32 skinny kernels, or for bf16 the
// decode kernels above
template <typename T>
Path choose_path(const void* x, const void* wg, const void* wu,
                 const void* wd, int P, int C, int D, int F, int gated,
                 int decode) {
  constexpr bool is_bf16 = std::is_same<T, bf16>::value;
  const bool weights_aligned =
      aligned16(wu) && aligned16(wd) && (!gated || aligned16(wg));
  if (decode && weights_aligned &&
      (is_bf16 ? decode_shapes_ok(P, C, D, F) && aligned16(x)
               : skinny_plan(P, C, D, F).use))
    return SKINNY;
  if (is_bf16 && tc_shapes_ok(D, F) && weights_aligned && aligned16(x))
    return TENSOR_CORE;
  return CUDA_CORE;
}

template <typename T>
cudaError_t launch(const void* x, const void* wg, const void* wu,
                   const void* wd, const int* se, const int* counts,
                   float* hidden, void* y, int P, int C, int D, int F,
                   int gated, int act, int decode, cudaStream_t st) {
  const Path path = choose_path<T>(x, wg, wu, wd, P, C, D, F, gated, decode);
  if (path == SKINNY) {
    if constexpr (std::is_same<T, bf16>::value)
      return launch_decode(x, wg, wu, wd, se, counts, hidden, y, P, C, D, F,
                           gated, act, st);
    const SkinnyPlan pl = skinny_plan(P, C, D, F);
    if (C <= 2)
      return launch_skinny<2>(pl, x, wg, wu, wd, se, counts, hidden, y, P, C,
                              D, F, gated, act, st);
    return launch_skinny<4>(pl, x, wg, wu, wd, se, counts, hidden, y, P, C,
                            D, F, gated, act, st);
  }
  if (path == TENSOR_CORE)
    return launch_tc(x, wg, wu, wd, se, counts, hidden, y, P, C, D, F, gated,
                     act, st);
  if (C <= 16)
    return launch_bm<T, 16>(x, wg, wu, wd, se, counts, hidden, y, P, C, D, F,
                            gated, act, st);
  return launch_bm<T, 64>(x, wg, wu, wd, se, counts, hidden, y, P, C, D, F,
                          gated, act, st);
}

}  // namespace

// Float32 elements of the workspace moe_ffn needs for these shapes.
extern "C" long long moe_ffn_workspace(int P, int C, int D, int F,
                                       int dtype, int decode) {
  return (long long)(dtype == 0
                         ? workspace_floats<float>(P, C, D, F, decode)
                         : workspace_floats<__nv_bfloat16>(P, C, D, F,
                                                           decode));
}

// Tensor maps of expert banks the decode path has made since the library
// was loaded: a run whose banks all fit the cache stops adding to it once
// every bank was met. Launches nothing.
extern "C" long long moe_ffn_tensor_maps() { return maps_encoded; }

// The path moe_ffn takes for these arguments: 0 = skinny (the decode path),
// 1 = tensor-core tile, 2 = CUDA-core tile; -1 for an unknown dtype.
extern "C" int moe_ffn_path(const void* x, const void* wg, const void* wu,
                            const void* wd, int P, int C, int D, int F,
                            int gated, int dtype, int decode) {
  if (dtype == 0)
    return choose_path<float>(x, wg, wu, wd, P, C, D, F, gated, decode);
  if (dtype == 1)
    return choose_path<__nv_bfloat16>(x, wg, wu, wd, P, C, D, F, gated,
                                      decode);
  return -1;
}

// x [P,C,D]; wg/wu [E,D,F] (wg ignored when gated == 0); wd [E,F,D];
// slot_expert [P] int32 (-1 = empty slot, reads expert 0 like the
// reference's gather); counts [P] int32; workspace: float32 scratch of
// moe_ffn_workspace() elements; -> y [P,C,D]; all contiguous. act 0 =
// silu, 1 = gelu (tanh form). dtype 0 = float32, 1 = bfloat16. decode 1
// = a decode step (may take the decode path), 0 = a prefill or chunk call.
// Returns cudaGetLastError().
extern "C" int moe_ffn(const void* x, const void* wg, const void* wu,
                       const void* wd, const void* slot_expert,
                       const void* counts, void* hidden, void* y, int P,
                       int C, int D, int F, int gated, int act, int dtype,
                       int decode, void* stream) {
  if (P <= 0 || C <= 0 || D <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* se = (const int*)slot_expert;
  const int* cn = (const int*)counts;
  float* h = (float*)hidden;
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(x, wg, wu, wd, se, cn, h, y, P, C, D, F, gated, act,
                        decode, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(x, wg, wu, wd, se, cn, h, y, P, C, D, F,
                                gated, act, decode, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
