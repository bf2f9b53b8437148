// Mamba2 / SSD chunked selective-state-space scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan.py::ssm_scan
// (_ssm_kernel): from a zero initial state, per (batch row b, head h) and
// chunk of T steps,
//   seg[i]    = cumsum(dt)[i] * a                        (log decay)
//   W[i,j]    = (C_i . B_j) * exp(seg[i] - seg[j]) * dt[j]   for i >= j
//   y[i]      = sum_j W[i,j] x[j] + exp(seg[i]) * (C_i . h_in)
//   h_out     = exp(seg[T-1]) h_in + sum_t x[t] (dt[t] exp(seg[T-1] -
//               seg[t])) B_t^T
// with y in x's dtype and the final state h [P, N] in float32. All math is
// float32, as in the TPU kernel.
//
// What bounds it on an H100: operations. At the serving shape (one
// 128-token prompt, 112 heads, P = N = T = 64) it reads and writes about
// 5.6 MB but does about 0.35 GFLOP of float32 work (the causal halves
// counted), which the CUDA cores (67 TFLOP/s) take about 5 us for,
// against 1.7 us for the bytes.
//
// Design: the chunk-parallel form of the SSD. A thread block cluster per
// (b, h) holds one block per chunk (at most 8; more chunks run in rounds
// of 8), so the chunks of a head run side by side on several SMs instead
// of one after another in one block. Each block of 256 threads stages its
// chunk's x, B and C in shared memory (x converted to float32), takes the
// prefix sum of dt in one thread (T adds, in step order), then three
// products: W = mask(C B^T) * decay (a warp skips the column groups above
// its rows), y_diag = W x (a warp stops at its last row: the terms past
// the diagonal are zeros), and the chunk's own
// state contribution s = (x * cw)^T B. The chain h_c = exp(seg_T) h_(c-1)
// + s_c is elementwise over [P, N]: after a cluster barrier every block
// folds the s and exp(seg_T) of the earlier chunks of the cluster, read
// from their shared memory (distributed shared memory), in chunk order,
// into its own h_in, then adds exp(seg) (C h_in^T) to y_diag. Every
// element keeps the order of sums of the one-block-per-head form this
// replaced: each product sums its reduction axis in ascending order in one
// thread (fma by fma; zero padding and the skipped zeros past the
// diagonal only add exact zeros), and the chain is etot * h + s chunk by
// chunk from a zero state. So y and h do not depend on the launch, on B,
// on H or on the cluster size.
//
// The products read float4s along the reduction axis (rows 68 floats
// apart: 16-byte aligned, and 16 consecutive rows fall in distinct bank
// groups), a thread owning 4 consecutive rows and 4 columns 16 apart,
// so shared-memory reads do not bound the multiply-adds. The decay is
// masked in log space: for j > i the entry is 0 without evaluating
// exp(seg[i] - seg[j]), which is positive there and overflows to inf
// before a causal zeroing could apply (inf * 0 = NaN). Five 64 x 68 tiles
// take 87 KB: two blocks fit an SM.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace repro;

constexpr int NT = 256;        // threads per block: a 16 x 16 grid
constexpr int MAXD = 64;       // largest T, P and N the kernel takes
constexpr int LD = MAXD + 4;   // row stride of the shared tiles (floats)
constexpr int TILE = MAXD * LD;
constexpr int MAX_CLUSTER = 8; // blocks of a cluster (portable size)
constexpr size_t SMEM_BYTES = (5 * TILE + 4 * MAXD) * sizeof(float);

// acc[a][j] += sum over k in [0, K) of A[r_a][k] * B[c_j][k], for this
// thread's rows r_a = 4 ty + a and columns c_j = tx + 16 j, j < JN; both
// operands k-contiguous with row stride LD, K a multiple of 4 (the tiles
// are zero past their extent). Each sum runs in ascending k, one fma a
// term.
template <int JN = 4>
__device__ __forceinline__ void product(float (&acc)[4][4], const float* A,
                                        const float* B, int K, int ty,
                                        int tx) {
  const float* a0 = A + 4 * ty * LD;
  const float* b0 = B + tx * LD;
  for (int k = 0; k < K; k += 4) {
    float4 av[4], bv[JN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a0 + i * LD + k);
#pragma unroll
    for (int j = 0; j < JN; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b0 + 16 * j * LD + k);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        acc[i][j] += av[i].x * bv[j].x;
        acc[i][j] += av[i].y * bv[j].y;
        acc[i][j] += av[i].z * bv[j].z;
        acc[i][j] += av[i].w * bv[j].w;
      }
  }
}

// C B^T on and below the diagonal: warp w (rows 8 w .. 8 w + 7) needs the
// columns c <= 8 w + 7 only, the first w / 2 + 1 of its 16-column groups
// (the entries above the diagonal are masked to 0 whatever they hold)
__device__ __forceinline__ void product_causal(float (&acc)[4][4],
                                               const float* A, const float* B,
                                               int K, int ty, int tx,
                                               int warp) {
  switch (warp >> 1) {
    case 0: product<1>(acc, A, B, K, ty, tx); break;
    case 1: product<2>(acc, A, B, K, ty, tx); break;
    case 2: product<3>(acc, A, B, K, ty, tx); break;
    default: product<4>(acc, A, B, K, ty, tx); break;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 2)
ssm_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const float* __restrict__ bm,
                const float* __restrict__ cm, T* __restrict__ y,
                float* __restrict__ hout, int S, int H, int P, int N,
                int Tc) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  float* cs = smem;                 // C chunk   [t][n]
  float* bs = cs + TILE;            // B chunk   [t][n], then s_c [p][n]
  float* bt = bs + TILE;            // B^T       [n][t], then h_in [p][n]
  float* xt = bt + TILE;            // x^T       [p][t], then x^T * cw
  float* ws = xt + TILE;            // W         [i][j]
  float* seg = ws + TILE;           // [T]
  float* dts = seg + MAXD;          // [T]
  float* cw = dts + MAXD;           // [T] dt[t] exp(seg[T-1] - seg[t])
  float* etot = cw + MAXD;          // exp(seg[T-1])

  const int CL = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int warp = tid >> 5;        // rows 8 warp .. 8 warp + 7
  const float ah = a[h];
  const int nc = S / Tc;
  const int T4 = (Tc + 3) & ~3, N4 = (N + 3) & ~3;

  // the state before the current round's first chunk, at (p, n) = (4 ty +
  // i, tx + 16 j): the elements of s and h_in this thread owns
  float hr[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) hr[i][j] = 0.f;

  for (int c0 = 0; c0 < nc; c0 += CL) {
    const int c = c0 + rank;        // this block's chunk in the round
    const int nact = min(CL, nc - c0);
    const int t0 = c * Tc;
    float acc[4][4];                // y_diag at (i, p) = (4 ty + i, tx + 16 j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    if (c < nc) {
      // stage the chunk: every load issued before the first store, so
      // their latencies overlap (thread tid takes (t, n) = (tid / 64 + 4
      // i, tid % 64) of C and B, the same (t, p) of x)
      constexpr int PER = MAXD * MAXD / NT;
      const int col = tid % MAXD;
      float cv[PER], bv[PER], xv[PER];
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int t = tid / MAXD + i * (NT / MAXD);
        const size_t off = ((size_t)b * S + t0 + t) * N + col;
        const bool ok = t < Tc && col < N;
        cv[i] = ok ? cm[off] : 0.f;
        bv[i] = ok ? bm[off] : 0.f;
        xv[i] = t < Tc && col < P
                    ? to_f(x[(((size_t)b * S + t0 + t) * H + h) * P + col])
                    : 0.f;
      }
      const float dv =
          tid < Tc ? dt[((size_t)b * S + t0 + tid) * H + h] : 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int t = tid / MAXD + i * (NT / MAXD);
        cs[t * LD + col] = cv[i];
        bs[t * LD + col] = bv[i];
        bt[col * LD + t] = bv[i];
        xt[col * LD + t] = xv[i];
      }
      if (tid < MAXD) dts[tid] = dv;
      __syncthreads();
      if (tid == 0) {
        // the prefix sum of dt in step order, from registers
        float d[MAXD];
#pragma unroll
        for (int t = 0; t < MAXD; t += 4) {
          const float4 v = *reinterpret_cast<const float4*>(dts + t);
          d[t] = v.x;
          d[t + 1] = v.y;
          d[t + 2] = v.z;
          d[t + 3] = v.w;
        }
        float run = 0.f;
#pragma unroll
        for (int t = 0; t < MAXD; ++t) {
          if (t < Tc) {
            run += d[t];
            seg[t] = run * ah;
          }
        }
        *etot = expf(seg[Tc - 1]);
      }
      __syncthreads();
      if (tid < Tc) cw[tid] = dts[tid] * expf(seg[Tc - 1] - seg[tid]);

      // W[i][j] = (C_i . B_j) * exp(seg_i - seg_j) * dt_j, masked (i >= j)
      float g[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) g[i][j] = 0.f;
      product_causal(g, cs, bs, N4, ty, tx, warp);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = 4 * ty + i, col = tx + 16 * j;
          ws[r * LD + col] = r < Tc && col < Tc && r >= col
                                 ? g[i][j] * expf(seg[r] - seg[col]) * dts[col]
                                 : 0.f;
        }
      __syncthreads();

      // y_diag[i][p] = sum_j W[i][j] x[j][p]: W is 0 past the diagonal,
      // so a warp stops after its last row
      product(acc, ws, xt, min(T4, 8 * warp + 8), ty, tx);
      __syncthreads();              // every thread has read x^T

      for (int idx = tid; idx < MAXD * MAXD; idx += NT) {
        const int p = idx / MAXD, t = idx % MAXD;
        if (t < Tc) xt[p * LD + t] *= cw[t];
      }
      __syncthreads();

      // s[p][n] = sum_t (x[t][p] cw[t]) B[t][n], into bs (B is read no
      // more) for the other blocks of the cluster
      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
      product(sc, xt, bt, T4, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bs[(4 * ty + i) * LD + tx + 16 * j] = sc[i][j];
    }
    cluster.sync();                 // the round's s and etot are visible

    // the chain, chunk by chunk: h = etot_r * h + s_r; before chunk
    // `rank`'s own term, h is its h_in (kept in bt, B^T being read no
    // more); after the last, the state before the next round
    for (int r = 0; r < nact; ++r) {
      if (r == rank) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            bt[(4 * ty + i) * LD + tx + 16 * j] = hr[i][j];
      }
      const float* sr = cluster.map_shared_rank(bs, r);
      const float er = *cluster.map_shared_rank(etot, r);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          hr[i][j] = er * hr[i][j] + sr[(4 * ty + i) * LD + tx + 16 * j];
    }
    __syncthreads();                // h_in complete

    if (c < nc) {
      // y[i][p] = y_diag + exp(seg_i) * sum_n C[i][n] h_in[p][n]; the
      // first chunk's h_in is 0, so its sum is an exact +0
      float ys[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) ys[i][j] = 0.f;
      if (c > 0) product(ys, cs, bt, N4, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * ty + i;
        if (r >= Tc) continue;
        const float es = expf(seg[r]);
        const size_t row = (((size_t)b * S + t0 + r) * H + h) * P;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          if (p < P) store(&y[row + p], acc[i][j] + ys[i][j] * es);
        }
      }
    }
    cluster.sync();                 // no block reads this round's s again
  }
  if (rank == 0) {
    float* ho = hout + ((size_t)b * H + h) * P * N;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = 4 * ty + i, n = tx + 16 * j;
        if (p < P && n < N) ho[p * N + n] = hr[i][j];
      }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* a,
                   const float* b, const float* c, void* y, float* hout,
                   int B, int S, int H, int P, int N, int Tc,
                   cudaStream_t st) {
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssm_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_BYTES);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const int nc = S / Tc;
  const int cl = nc < MAX_CLUSTER ? nc : MAX_CLUSTER;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, H, B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, ssm_scan_kernel<T>, (const T*)x, dt, a, b, c, (T*)y, hout, S, H,
      P, N, Tc);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// x [B,S,H,P] (dtype 0 = float32, 1 = bfloat16); dt [B,S,H], a [H],
// b/c [B,S,N] float32 -> y [B,S,H,P] in x's dtype, hout [B,H,P,N] float32;
// all contiguous. Tc is the chunk length: it divides S, and Tc, P and N
// are each at most 64. Returns cudaGetLastError() after the launch.
extern "C" int ssm_scan(const void* x, const void* dt, const void* a,
                        const void* b, const void* c, void* y, void* hout,
                        int B, int S, int H, int P, int N, int Tc, int dtype,
                        void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || Tc <= 0 ||
      Tc > MAXD || P > MAXD || N > MAXD || S % Tc != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(x, (const float*)dt, (const float*)a,
                        (const float*)b, (const float*)c, y, (float*)hout, B,
                        S, H, P, N, Tc, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(x, (const float*)dt, (const float*)a,
                                (const float*)b, (const float*)c, y,
                                (float*)hout, B, S, H, P, N, Tc, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
