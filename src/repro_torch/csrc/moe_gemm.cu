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
// flops each; at prefill (C in the tens to hundreds) operations. The
// prefill path uses the tensor cores through wmma (the warp-level mma.sync
// instructions), without the asynchronous wgmma/TMA pipeline that would
// approach the card's peak; that comes later.
//
// Design: the TPU kernel accumulates the down projection across sequential
// F tiles; blocks here run in parallel, so the FFN is two GEMM-shaped
// passes with the hidden activation in scratch between them (act(g) * u
// applied when the gate/up sums are complete). Three paths, chosen from
// the dtype, C and alignment:
//   * skinny (C <= 4, the decode step; bytes-bound): each thread streams
//     16-byte vectors of weight columns, the reduction axis is split over
//     blocks so enough loads are in flight, and split partials are summed
//     in a fixed order by small finalize kernels (deterministic, no
//     atomics);
//   * tensor-core tile (bf16, C > 4: prefill): wmma 16x16x16 bf16
//     fragments with float32 accumulators, 64 x 64 tiles per block; the
//     hidden activation stays float32 between the two passes, as in the
//     TPU kernel, and enters the down product as a hi + lo pair of bf16
//     tiles (two mma per step);
//   * CUDA-core tile (float32, and shapes the other paths cannot take):
//     one block per (128 columns, BM-row tile, slot), x staged in shared
//     memory, one column per thread with BM float32 sums in registers
//     (BM = 16 or 64 from C).
// Every path computes a slot only from its expert's rows and its own x, so
// a shadow slot reproduces its primary bit for bit.
#include <cuda_bf16.h>
#include <mma.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

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
// Skinny path (C <= 4, the decode step): bytes-bound weight streaming.
// Each thread owns 16 bytes of columns (8 bf16 or 4 float32 values, one
// vector load per weight row) and the reduction axis is split over
// blockIdx.y so that enough loads are in flight to approach the memory
// rate. Split partials go to float32 scratch and are summed in split order
// by the finalize kernels: deterministic, and independent of which slot
// serves an expert (so a shadow slot reproduces its primary bit for bit).
// ---------------------------------------------------------------------------

constexpr int SK_NT = 128;            // threads per skinny block
constexpr int TARGET_BLOCKS = 2048;   // blocks to aim for per launch
constexpr int MAX_KCHUNK = 2048;      // BM * MAX_KCHUNK floats of smem

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// part[s, p, m, n] = sum over k in split s of A[p, m, k] * W[e, k, n]
// (and the same for W1 when DUAL). A: [P, C, K]; W: [E, K, N].
template <typename T, typename AT, int BM, bool DUAL>
__global__ void __launch_bounds__(SK_NT)
skinny_partial_kernel(const AT* __restrict__ A, const T* __restrict__ W0,
                      const T* __restrict__ W1,
                      const int* __restrict__ slot_expert,
                      const int* __restrict__ counts,
                      float* __restrict__ part0, float* __restrict__ part1,
                      int P, int C, int K, int N, int kchunk) {
  constexpr int V = Vec<T>::N;
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
    as[idx] = (m < C && kk < kn)
                  ? to_f(A[((size_t)p * C + m) * K + k0 + kk]) : 0.f;
  }
  __syncthreads();
  if (n0 >= N) return;

  float acc0[BM][V], acc1[BM][V];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int v = 0; v < V; ++v) acc0[m][v] = acc1[m][v] = 0.f;

  const T* w0 = W0 + ((size_t)e * K + k0) * N + n0;
  const T* w1 = DUAL ? W1 + ((size_t)e * K + k0) * N + n0 : nullptr;
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

template <typename T>
__global__ void finalize_out_kernel(const float* __restrict__ part,
                                    const int* __restrict__ counts,
                                    T* __restrict__ y, int P, int C, int D,
                                    int S) {
  const size_t n = (size_t)P * C * D;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float acc = 0.f;
  if (counts[idx / ((size_t)C * D)] > 0)
    for (int s = 0; s < S; ++s) acc += part[s * n + idx];
  store(&y[idx], acc);
}

struct SkinnyPlan {
  bool use = false;
  int s1 = 1, kc1 = 1;      // gate/up: splits of D and their length
  int s2 = 1, kc2 = 1;      // down: splits of F and their length
};

template <typename T>
SkinnyPlan skinny_plan(int P, int C, int D, int F) {
  constexpr int V = Vec<T>::N;
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

template <typename T, int BM>
cudaError_t launch_skinny(const SkinnyPlan& pl, const void* x,
                          const void* wg, const void* wu, const void* wd,
                          const int* se, const int* counts, float* ws,
                          void* y, int P, int C, int D, int F, int gated,
                          int act, cudaStream_t st) {
  constexpr int V = Vec<T>::N;
  float* hidden = ws;
  float* p0 = hidden + (size_t)P * C * F;
  float* p1 = p0 + (size_t)pl.s1 * P * C * F;
  float* p2 = p1 + (size_t)pl.s1 * P * C * F;
  const dim3 g1((F + V * SK_NT - 1) / (V * SK_NT), pl.s1, P);
  const size_t sm1 = (size_t)BM * pl.kc1 * sizeof(float);
  if (gated)
    skinny_partial_kernel<T, T, BM, true><<<g1, SK_NT, sm1, st>>>(
        (const T*)x, (const T*)wg, (const T*)wu, se, counts, p0, p1, P, C,
        D, F, pl.kc1);
  else
    skinny_partial_kernel<T, T, BM, false><<<g1, SK_NT, sm1, st>>>(
        (const T*)x, (const T*)wu, nullptr, se, counts, p0, nullptr, P, C,
        D, F, pl.kc1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t nh = (size_t)P * C * F;
  finalize_hidden_kernel<<<(unsigned)((nh + 255) / 256), 256, 0, st>>>(
      p0, p1, counts, hidden, P, C, F, pl.s1, gated, act);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 g2((D + V * SK_NT - 1) / (V * SK_NT), pl.s2, P);
  const size_t sm2 = (size_t)BM * pl.kc2 * sizeof(float);
  skinny_partial_kernel<T, float, BM, false><<<g2, SK_NT, sm2, st>>>(
      hidden, (const T*)wd, nullptr, se, counts, p2, nullptr, P, C, F, D,
      pl.kc2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t ny = (size_t)P * C * D;
  finalize_out_kernel<T><<<(unsigned)((ny + 255) / 256), 256, 0, st>>>(
      p2, counts, (T*)y, P, C, D, pl.s2);
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
// Tensor-core tile path (bf16, C > 4: prefill). One block of 4 warps per
// (64 rows, 64 columns, slot) tile; 32-deep k steps staged in shared
// memory with 16-byte loads; each warp owns a 32 x 32 quarter as 2 x 2
// wmma 16x16x16 bf16 fragments with float32 accumulators (gate and up
// share the fragment layout, so act(g) * u is taken element by element).
// The hidden activation is stored in float32, in a row-padded [P, Cpad, F]
// layout (padded rows are zero because their x rows are). The down product
// splits each staged hidden value h into hi = bf16(h) and lo = bf16(h - hi)
// and accumulates hi @ wd + lo @ wd: hi + lo carries h to about 16
// significant bits and each product is exact in float32, so the result
// matches a float32 hidden @ bf16 wd to float32 summation order, where a
// single bf16 hidden would cost up to 2^-8 of each term.
// ---------------------------------------------------------------------------

constexpr int TC_BM = 64, TC_BN = 64, TC_BK = 32, TC_NT = 128;
constexpr int A_LD = TC_BK + 8;     // bf16 row pitch of the A tile
constexpr int B_LD = TC_BN + 8;     // bf16 row pitch of the B tiles
constexpr int C_LD = TC_BN + 4;     // float row pitch of the output tile

using bf16 = __nv_bfloat16;

// A [rows x 32] tile (row-major, leading dim lda) -> shared; rows past
// nrows and columns past kvalid are zero (kvalid is a multiple of 8)
__device__ __forceinline__ void stage_a(bf16* dst, const bf16* src, int lda,
                                        int nrows, int kvalid) {
  for (int c = threadIdx.x; c < TC_BM * TC_BK / 8; c += TC_NT) {
    const int r = c / (TC_BK / 8);
    const int k8 = (c % (TC_BK / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < nrows && k8 < kvalid)
      v = __ldg(reinterpret_cast<const uint4*>(src + (size_t)r * lda + k8));
    *reinterpret_cast<uint4*>(dst + r * A_LD + k8) = v;
  }
}

// B [32 x 64] tile (row-major, leading dim ldb) -> shared; rows past
// kvalid and columns past nvalid (a multiple of 8) are zero
__device__ __forceinline__ void stage_b(bf16* dst, const bf16* src, int ldb,
                                        int kvalid, int nvalid) {
  for (int c = threadIdx.x; c < TC_BK * TC_BN / 8; c += TC_NT) {
    const int r = c / (TC_BN / 8);
    const int n8 = (c % (TC_BN / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < kvalid && n8 < nvalid)
      v = __ldg(reinterpret_cast<const uint4*>(src + (size_t)r * ldb + n8));
    *reinterpret_cast<uint4*>(dst + r * B_LD + n8) = v;
  }
}

// A [64 x 32] float32 tile (row-major, leading dim lda) -> shared as two
// bf16 tiles, hi = bf16(a) and lo = bf16(a - hi); columns past kvalid (a
// multiple of 8) are zero
__device__ __forceinline__ void stage_a_split(bf16* hi, bf16* lo,
                                              const float* src, int lda,
                                              int kvalid) {
  for (int c = threadIdx.x; c < TC_BM * TC_BK / 4; c += TC_NT) {
    const int r = c / (TC_BK / 4);
    const int k4 = (c % (TC_BK / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k4 < kvalid)
      v = __ldg(reinterpret_cast<const float4*>(src + (size_t)r * lda + k4));
    const float a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bf16 h = __float2bfloat16(a[i]);
      hi[r * A_LD + k4 + i] = h;
      lo[r * A_LD + k4 + i] = __float2bfloat16(a[i] - __bfloat162float(h));
    }
  }
}

using FragA = nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16,
                                     bf16, nvcuda::wmma::row_major>;
using FragB = nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16,
                                     bf16, nvcuda::wmma::row_major>;
using FragC = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16,
                                     float>;

// acc[i][j] += A[rows wr*32 + 16i] @ B[cols wc*32 + 16j] over one k step
__device__ __forceinline__ void mma_step(FragC (&acc)[2][2], const bf16* as,
                                         const bf16* bs, int wr, int wc) {
#pragma unroll
  for (int kk = 0; kk < TC_BK; kk += 16) {
    FragA a[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      nvcuda::wmma::load_matrix_sync(a[i], as + (wr * 32 + i * 16) * A_LD + kk,
                                     A_LD);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      FragB b;
      nvcuda::wmma::load_matrix_sync(b, bs + kk * B_LD + wc * 32 + j * 16,
                                     B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        nvcuda::wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
    }
  }
}

template <bool GATED>
__global__ void __launch_bounds__(TC_NT)
moe_gate_up_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wg,
                      const bf16* __restrict__ wu,
                      const int* __restrict__ slot_expert,
                      const int* __restrict__ counts,
                      float* __restrict__ hidden, int C, int Cpad, int D,
                      int F, int act) {
  const int p = blockIdx.z;
  if (counts[p] <= 0) return;                   // block-uniform
  const int e = max(slot_expert[p], 0);
  const int m0 = blockIdx.y * TC_BM;
  const int n0 = blockIdx.x * TC_BN;
  const int warp = threadIdx.x >> 5;
  const int wr = warp >> 1, wc = warp & 1;

  __shared__ __align__(32) bf16 xs[TC_BM * A_LD];
  __shared__ __align__(32) bf16 gs[TC_BK * B_LD];
  __shared__ __align__(32) bf16 us[TC_BK * B_LD];
  __shared__ __align__(32) float cs[TC_BM * C_LD];

  FragC ag[2][2], au[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      nvcuda::wmma::fill_fragment(ag[i][j], 0.f);
      nvcuda::wmma::fill_fragment(au[i][j], 0.f);
    }
  const bf16* xp = x + ((size_t)p * C + m0) * D;
  const int nrows = min(TC_BM, C - m0);
  for (int k0 = 0; k0 < D; k0 += TC_BK) {
    const size_t woff = ((size_t)e * D + k0) * F + n0;
    stage_a(xs, xp + k0, D, nrows, D - k0);
    stage_b(us, wu + woff, F, min(TC_BK, D - k0), F - n0);
    if (GATED) stage_b(gs, wg + woff, F, min(TC_BK, D - k0), F - n0);
    __syncthreads();
    mma_step(au, xs, us, wr, wc);
    if (GATED) mma_step(ag, xs, gs, wr, wc);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int t = 0; t < au[i][j].num_elements; ++t)
        au[i][j].x[t] = GATED ? act_fn(ag[i][j].x[t], act) * au[i][j].x[t]
                              : act_fn(au[i][j].x[t], act);
      nvcuda::wmma::store_matrix_sync(
          cs + (wr * 32 + i * 16) * C_LD + wc * 32 + j * 16, au[i][j], C_LD,
          nvcuda::wmma::mem_row_major);
    }
  __syncthreads();
  for (int idx = threadIdx.x; idx < TC_BM * TC_BN; idx += TC_NT) {
    const int r = idx / TC_BN, c = idx % TC_BN;
    if (n0 + c < F)
      hidden[((size_t)p * Cpad + m0 + r) * F + n0 + c] = cs[r * C_LD + c];
  }
}

__global__ void __launch_bounds__(TC_NT)
moe_down_tc_kernel(const float* __restrict__ hidden,
                   const bf16* __restrict__ wd,
                   const int* __restrict__ slot_expert,
                   const int* __restrict__ counts, bf16* __restrict__ y,
                   int C, int Cpad, int D, int F) {
  const int p = blockIdx.z;
  const int m0 = blockIdx.y * TC_BM;
  const int n0 = blockIdx.x * TC_BN;
  if (counts[p] <= 0) {                         // block-uniform
    for (int idx = threadIdx.x; idx < TC_BM * TC_BN; idx += TC_NT) {
      const int r = idx / TC_BN, c = idx % TC_BN;
      if (m0 + r < C && n0 + c < D)
        y[((size_t)p * C + m0 + r) * D + n0 + c] = __float2bfloat16(0.f);
    }
    return;
  }
  const int e = max(slot_expert[p], 0);
  const int warp = threadIdx.x >> 5;
  const int wr = warp >> 1, wc = warp & 1;

  __shared__ __align__(32) bf16 hs[TC_BM * A_LD];
  __shared__ __align__(32) bf16 hl[TC_BM * A_LD];
  __shared__ __align__(32) bf16 ds[TC_BK * B_LD];
  __shared__ __align__(32) float cs[TC_BM * C_LD];

  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.f);
  const float* hp = hidden + ((size_t)p * Cpad + m0) * F;
  for (int k0 = 0; k0 < F; k0 += TC_BK) {
    stage_a_split(hs, hl, hp + k0, F, F - k0);
    stage_b(ds, wd + ((size_t)e * F + k0) * D + n0, D, min(TC_BK, F - k0),
            D - n0);
    __syncthreads();
    mma_step(acc, hs, ds, wr, wc);
    mma_step(acc, hl, ds, wr, wc);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      nvcuda::wmma::store_matrix_sync(
          cs + (wr * 32 + i * 16) * C_LD + wc * 32 + j * 16, acc[i][j], C_LD,
          nvcuda::wmma::mem_row_major);
  __syncthreads();
  for (int idx = threadIdx.x; idx < TC_BM * TC_BN; idx += TC_NT) {
    const int r = idx / TC_BN, c = idx % TC_BN;
    if (m0 + r < C && n0 + c < D)
      y[((size_t)p * C + m0 + r) * D + n0 + c] =
          __float2bfloat16(cs[r * C_LD + c]);
  }
}

int padded_rows(int C) { return (C + TC_BM - 1) / TC_BM * TC_BM; }

cudaError_t launch_tc(const void* x, const void* wg, const void* wu,
                      const void* wd, const int* se, const int* counts,
                      float* ws, void* y, int P, int C, int D, int F,
                      int gated, int act, cudaStream_t st) {
  const int Cpad = padded_rows(C);
  float* hidden = ws;
  const dim3 g1((F + TC_BN - 1) / TC_BN, Cpad / TC_BM, P);
  if (gated)
    moe_gate_up_tc_kernel<true><<<g1, TC_NT, 0, st>>>(
        (const bf16*)x, (const bf16*)wg, (const bf16*)wu, se, counts, hidden,
        C, Cpad, D, F, act);
  else
    moe_gate_up_tc_kernel<false><<<g1, TC_NT, 0, st>>>(
        (const bf16*)x, (const bf16*)wu, (const bf16*)wu, se, counts, hidden,
        C, Cpad, D, F, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 g2((D + TC_BN - 1) / TC_BN, Cpad / TC_BM, P);
  moe_down_tc_kernel<<<g2, TC_NT, 0, st>>>(hidden, (const bf16*)wd, se,
                                           counts, (bf16*)y, C, Cpad, D, F);
  return cudaGetLastError();
}

bool tc_shapes_ok(int D, int F) { return D % 8 == 0 && F % 8 == 0; }

// float32 workspace the launch needs: the hidden activation (with padded
// rows on the tensor-core path), plus the split partials on the skinny
// path
template <typename T>
size_t workspace_floats(int P, int C, int D, int F) {
  size_t need = (size_t)P * C * F;
  const SkinnyPlan pl = skinny_plan<T>(P, C, D, F);
  if (pl.use)
    need += 2 * (size_t)pl.s1 * P * C * F + (size_t)pl.s2 * P * C * D;
  if (std::is_same<T, bf16>::value && tc_shapes_ok(D, F))
    need = std::max(need, (size_t)P * padded_rows(C) * F);
  return need;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

enum Path { SKINNY = 0, TENSOR_CORE = 1, CUDA_CORE = 2 };

template <typename T>
Path choose_path(const void* x, const void* wg, const void* wu,
                 const void* wd, int P, int C, int D, int F, int gated) {
  const bool weights_aligned =
      aligned16(wu) && aligned16(wd) && (!gated || aligned16(wg));
  if (skinny_plan<T>(P, C, D, F).use && weights_aligned) return SKINNY;
  if (std::is_same<T, bf16>::value && tc_shapes_ok(D, F) && weights_aligned &&
      aligned16(x))
    return TENSOR_CORE;
  return CUDA_CORE;
}

template <typename T>
cudaError_t launch(const void* x, const void* wg, const void* wu,
                   const void* wd, const int* se, const int* counts,
                   float* hidden, void* y, int P, int C, int D, int F,
                   int gated, int act, cudaStream_t st) {
  const Path path = choose_path<T>(x, wg, wu, wd, P, C, D, F, gated);
  if (path == SKINNY) {
    const SkinnyPlan pl = skinny_plan<T>(P, C, D, F);
    if (C <= 2)
      return launch_skinny<T, 2>(pl, x, wg, wu, wd, se, counts, hidden, y,
                                 P, C, D, F, gated, act, st);
    return launch_skinny<T, 4>(pl, x, wg, wu, wd, se, counts, hidden, y, P,
                               C, D, F, gated, act, st);
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
                                       int dtype) {
  return (long long)(dtype == 0 ? workspace_floats<float>(P, C, D, F)
                                : workspace_floats<__nv_bfloat16>(P, C, D, F));
}

// The path moe_ffn takes for these arguments: 0 = skinny (decode-shaped),
// 1 = tensor-core tile, 2 = CUDA-core tile; -1 for an unknown dtype.
extern "C" int moe_ffn_path(const void* x, const void* wg, const void* wu,
                            const void* wd, int P, int C, int D, int F,
                            int gated, int dtype) {
  if (dtype == 0)
    return choose_path<float>(x, wg, wu, wd, P, C, D, F, gated);
  if (dtype == 1)
    return choose_path<__nv_bfloat16>(x, wg, wu, wd, P, C, D, F, gated);
  return -1;
}

// x [P,C,D]; wg/wu [E,D,F] (wg ignored when gated == 0); wd [E,F,D];
// slot_expert [P] int32 (-1 = empty slot, reads expert 0 like the
// reference's gather); counts [P] int32; workspace: float32 scratch of
// moe_ffn_workspace() elements; -> y [P,C,D]; all contiguous. act 0 =
// silu, 1 = gelu (tanh form). dtype 0 = float32, 1 = bfloat16. Returns
// cudaGetLastError().
extern "C" int moe_ffn(const void* x, const void* wg, const void* wu,
                       const void* wd, const void* slot_expert,
                       const void* counts, void* hidden, void* y, int P,
                       int C, int D, int F, int gated, int act, int dtype,
                       void* stream) {
  if (P <= 0 || C <= 0 || D <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* se = (const int*)slot_expert;
  const int* cn = (const int*)counts;
  float* h = (float*)hidden;
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(x, wg, wu, wd, se, cn, h, y, P, C, D, F, gated, act,
                        st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(x, wg, wu, wd, se, cn, h, y, P, C, D, F,
                                gated, act, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
