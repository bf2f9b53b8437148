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
// 5.6 MB but does about 0.47 GFLOP of float32 work, which the CUDA cores
// (67 TFLOP/s) take about 7 us for, against 1.7 us for the bytes.
//
// Design: one block of 256 threads per (b, h); the TPU kernel's
// sequential chunk axis becomes a loop inside the block, and the [P, N]
// state stays in shared memory across chunks (nothing crosses blocks).
// Per chunk, x, dt, B and C are staged in shared memory (x converted to
// float32), one thread takes the prefix sum of dt (T <= 64 adds, in step
// order), and four small products run on a 16 x 16 thread grid with a
// 4 x 4 register tile per thread: G = C B^T masked and scaled into W, then
// y = W x + exp(seg) (C h^T) written straight out, then h <- exp(seg_T) h
// + (x * cw)^T B. Every product sums its reduction axis in ascending order
// in one thread, so the result does not depend on the launch.
//
// The decay is masked in log space: for j > i the entry is 0 without
// evaluating exp(seg[i] - seg[j]), which is positive there and overflows
// to inf before a causal zeroing could apply (inf * 0 = NaN).
//
// Shared arrays use a row stride of 65 floats, so a warp's column and row
// accesses both fall in distinct banks. The five 64 x 65 tiles take 83 KB,
// above the 48 KB default: the launch opts in once per instantiation.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int NT = 256;        // threads per block: a 16 x 16 grid
constexpr int MAXD = 64;       // largest T, P and N the kernel takes
constexpr int LD = MAXD + 1;   // padded row stride of the shared tiles
constexpr int TILE = MAXD * LD;
constexpr size_t SMEM_BYTES = (5 * TILE + 3 * MAXD) * sizeof(float);

// acc[i][j] += sum_k A(r_i, k) * B(c_j, k) over k in [0, K), for the rows
// r_i = ty + 16 i and columns c_j = tx + 16 j of this thread; A(r, k) is
// a[r * ar + k * ak], B(c, k) is b[c * bc + k * bk]. Rows >= R and columns
// >= C read row / column 0 and are never stored.
__device__ __forceinline__ void tile_product(
    float (&acc)[4][4], const float* a, int ar, int ak, const float* b,
    int bc, int bk, int R, int C, int K, int ty, int tx) {
  int ra[4], cb[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int c = tx + 16 * i;
    ra[i] = (r < R ? r : 0) * ar;
    cb[i] = (c < C ? c : 0) * bc;
  }
  for (int k = 0; k < K; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = a[ra[i] + k * ak];
      bv[i] = b[cb[i] + k * bk];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

template <typename T>
__global__ void __launch_bounds__(NT)
ssm_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const float* __restrict__ bm,
                const float* __restrict__ cm, T* __restrict__ y,
                float* __restrict__ hout, int S, int H, int P, int N,
                int Tc) {
  extern __shared__ float smem[];
  float* hs = smem;                 // state       [P][LD]  (p, n)
  float* xs = hs + TILE;            // x chunk     [T][LD]  (t, p)
  float* bs = xs + TILE;            // B chunk     [T][LD]  (t, n)
  float* cs = bs + TILE;            // C chunk     [T][LD]  (t, n)
  float* ws = cs + TILE;            // W           [T][LD]  (i, j)
  float* seg = ws + TILE;           // [T]
  float* dts = seg + MAXD;          // [T]
  float* cw = dts + MAXD;           // [T] dt[t] exp(seg[T-1] - seg[t])

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const float ah = a[h];

  for (int idx = tid; idx < P * N; idx += NT)
    hs[(idx / N) * LD + idx % N] = 0.f;

  for (int t0 = 0; t0 < S; t0 += Tc) {
    __syncthreads();   // the previous chunk is done with the tiles
    for (int idx = tid; idx < Tc * P; idx += NT) {
      const int t = idx / P, p = idx % P;
      xs[t * LD + p] =
          to_f(x[(((size_t)b * S + t0 + t) * H + h) * P + p]);
    }
    for (int idx = tid; idx < Tc * N; idx += NT) {
      const int t = idx / N, n = idx % N;
      const size_t off = ((size_t)b * S + t0 + t) * N + n;
      bs[t * LD + n] = bm[off];
      cs[t * LD + n] = cm[off];
    }
    for (int t = tid; t < Tc; t += NT)
      dts[t] = dt[((size_t)b * S + t0 + t) * H + h];
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int t = 0; t < Tc; ++t) {
        run += dts[t];
        seg[t] = run * ah;
      }
    }
    __syncthreads();
    for (int t = tid; t < Tc; t += NT)
      cw[t] = dts[t] * expf(seg[Tc - 1] - seg[t]);

    // W[i][j] = (C_i . B_j) * exp(seg_i - seg_j) * dt_j, masked (i >= j)
    float acc[4][4];
    zero(acc);
    tile_product(acc, cs, LD, 1, bs, LD, 1, Tc, Tc, N, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        if (r < Tc && c < Tc)
          ws[r * LD + c] =
              r >= c ? acc[i][j] * expf(seg[r] - seg[c]) * dts[c] : 0.f;
      }
    __syncthreads();

    // y[i][p] = sum_j W[i][j] x[j][p] + exp(seg_i) * sum_n C[i][n] h[p][n]
    float ys[4][4];
    zero(acc);
    zero(ys);
    tile_product(acc, ws, LD, 1, xs, 1, LD, Tc, P, Tc, ty, tx);
    tile_product(ys, cs, LD, 1, hs, LD, 1, Tc, P, N, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      if (r >= Tc) continue;
      const float es = expf(seg[r]);
      const size_t row = (((size_t)b * S + t0 + r) * H + h) * P;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        if (c < P) store(&y[row + c], acc[i][j] + ys[i][j] * es);
      }
    }
    __syncthreads();   // every thread has read h_in

    // h[p][n] = exp(seg_T) h[p][n] + sum_t (x[t][p] cw[t]) B[t][n]; each
    // thread updates only the entries it owns
    for (int idx = tid; idx < Tc * P; idx += NT) {
      const int t = idx / P, p = idx % P;
      xs[t * LD + p] *= cw[t];
    }
    __syncthreads();
    zero(acc);
    tile_product(acc, xs, 1, LD, bs, 1, LD, P, N, Tc, ty, tx);
    const float etot = expf(seg[Tc - 1]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        if (r < P && c < N) hs[r * LD + c] = etot * hs[r * LD + c] + acc[i][j];
      }
  }
  __syncthreads();
  float* ho = hout + ((size_t)b * H + h) * P * N;
  for (int idx = tid; idx < P * N; idx += NT)
    ho[idx] = hs[(idx / N) * LD + idx % N];
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
  ssm_scan_kernel<T><<<dim3(H, B), NT, SMEM_BYTES, st>>>(
      (const T*)x, dt, a, b, c, (T*)y, hout, S, H, P, N, Tc);
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
