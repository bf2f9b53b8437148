// Hopper (sm_90a) building blocks of the port's tensor-core kernels:
// asynchronous global -> shared copies (cp.async, with zero fill; TMA
// tensor copies with their mbarriers and tensor maps), the warpgroup
// matrix multiply (wgmma) with its descriptors and fences, and
// programmatic dependent launch.
//
// Shared-memory operand layout. Every wgmma operand here is stored in
// the no-swizzle ("interleave") canonical layout: the tile is cut into
// core matrices of 8 rows x 16 bytes (8 bf16), each 128 contiguous bytes,
// and a tile whose rows have W elements keeps core matrix (row group rg,
// column chunk cg) at byte (rg * W / 8 + cg) * 128 (stage_tile below).
// For a K-major operand (rows are M or N, columns K) the K-adjacent core
// matrices are then 128 bytes apart (the leading byte offset) and the
// M/N-adjacent ones W * 16 (the stride byte offset). For an MN-major
// operand (rows are K, columns N) the N-adjacent ones are 128 bytes apart
// (stride byte offset) and the K-adjacent ones W * 16 (leading). Any
// W that is a multiple of 8 works (head dims 80 and 112 included), with
// no padding; one k16 step is two core matrices along K.
//
// The wgmma wrappers list their accumulator registers one by one, as
// inline PTX requires; each exists for the N it is used at.
#pragma once

#include <cstdint>

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {
namespace sm90 {

// dynamic shared memory a block may take: the 227 KB limit less 1 KB
// for a kernel's static shared variables
constexpr int SMEM_MAX = 232448 - 1024;

// Let a kernel take up to SMEM_MAX bytes of dynamic shared memory; sized,
// a static of the caller's (one per kernel), makes this a one-time call.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, bool& sized) {
  if (sized) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  sized = err == cudaSuccess;
  return err;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte aligned address at or after p (shared memory)
__device__ __forceinline__ char* align1024(char* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// 16 bytes global -> shared, asynchronously; when !valid the 16 bytes are
// zero-filled and nothing is read (src must still be a mapped address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
#endif
}

// 4 bytes global -> shared, asynchronously, zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
#endif
}

// make this thread's generic-proxy writes to shared memory (cp.async,
// st.shared) visible to the async proxy that wgmma reads through; run by
// every writing thread before the barrier that precedes the wgmma
__device__ __forceinline__ void fence_proxy_async() {
#if defined(__CUDA_ARCH__)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#endif
}

__device__ __forceinline__ void wgmma_fence() {
#if defined(__CUDA_ARCH__)
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#endif
}

__device__ __forceinline__ void wgmma_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
#endif
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
#endif
}

// keep the compiler from moving accesses to registers a wgmma in flight
// owns across the fence or wait around it
template <int R>
__device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int R>
__device__ __forceinline__ void pin(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}
template <int R, int C>
__device__ __forceinline__ void pin(uint32_t (&d)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i) pin(d[i]);
}

// descriptor of a no-swizzle operand at p: leading and stride byte
// offsets as the layout note above says (multiples of 16, < 256 KB)
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// Issue the cp.async copies of a ROWS x W bf16 tile (ROWS a multiple of
// 8, W of 8) into the canonical layout at dst, by NT threads. Chunk c
// goes to row c % 8 of core matrix c / 8, so the 8 lanes that write one
// core matrix write 128 contiguous bytes and neighbouring lanes read
// neighbouring 16-byte chunks of a row. src(r, cg) gives the chunk's
// global address and whether it exists (else it is zero-filled).
template <int ROWS, int W, int NT, typename Src>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, Src src) {
  constexpr int CHUNKS = ROWS * W / 8;
  char* base = reinterpret_cast<char*>(dst);
#pragma unroll 4
  for (int c = threadIdx.x % NT; c < CHUNKS; c += NT) {
    const int core = c >> 3;
    const int r = (core / (W / 8)) * 8 + (c & 7);
    const int cg = core % (W / 8);
    bool ok;
    const void* g = src(r, cg, ok);
    cp_async16(base + ((core << 7) | ((c & 7) << 4)), g, ok);
  }
}

// Issue the cp.async copies of a ROWS x W bf16 MN-major operand (rows are
// K; W a multiple of 64) into the 128-byte swizzled canonical layout at
// dst (1024-byte aligned): 8-row x 64-element atoms of 1024 bytes, the
// atoms of column group a (64 columns) at a * ROWS * 128 bytes, and
// 16-byte chunk c of row r at chunk c ^ (r % 8) of its 128-byte row.
// Neighbouring lanes read neighbouring chunks of one row (a warp reads
// 512 contiguous bytes) and the swizzle spreads their writes over all
// banks. Its descriptor is desc_sw128(tile, ROWS * 128).
template <int ROWS, int W, int NT, typename Src>
__device__ __forceinline__ void stage_tile_sw128(__nv_bfloat16* dst,
                                                 Src src) {
  constexpr int CPR = W / 8;                  // chunks per row
  char* base = reinterpret_cast<char*>(dst);
#pragma unroll 4
  for (int c = threadIdx.x % NT; c < ROWS * CPR; c += NT) {
    const int r = c / CPR, cg = c % CPR;
    bool ok;
    const void* g = src(r, cg, ok);
    cp_async16(base + (cg >> 3) * ROWS * 128 + r * 128 +
                   (((cg & 7) ^ (r & 7)) << 4),
               g, ok);
  }
}

// descriptor of a 128-byte swizzled MN-major operand at p (1024-byte
// aligned): leading byte offset lbo between 64-column atoms, stride byte
// offset 1024 between 8-row groups
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo) {
  return desc(p, lbo, 1024) | (1ull << 62);
}

// (row, column pair) of accumulator element i of thread t in a
// warpgroup's m64nN fragment: rows (t / 32) * 16 + (t % 32) / 4 (+ 8 for
// the odd pairs), columns (i / 4) * 8 + (t % 4) * 2 (+ 1)
__device__ __forceinline__ int frag_row(int t, int i) {
  return ((t >> 5) << 4) + ((t & 31) >> 2) + ((i >> 1) & 1) * 8;
}
__device__ __forceinline__ int frag_col(int t, int i) {
  return (i >> 2) * 8 + (t & 3) * 2 + (i & 1);
}

// 2^x by the special-function unit (relative error about 2^-22; results
// below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
#if defined(__CUDA_ARCH__)
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
#else
  y = x;
#endif
  return y;
}

// two floats as one bf16x2 register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64]; A and B from shared memory
// (descriptors), B K-major. scale_d 0 ignores D's old value.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
#endif
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128]; A and B from shared memory
// (descriptors), B MN-major. scale_d 0 ignores D's old value.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
#endif
}

// D[64 x 8] (+)= A[64 x 16] * B[16 x 8]; A MN-major (the 128-byte
// swizzled layout of stage_tile_sw128: 64 M-elements a row, rows are K),
// B K-major (no-swizzle core matrices), both from shared memory. The
// "swapped" product of a decode step: A is a tile of 64 weight columns,
// B the (at most 8) tokens.
__device__ __forceinline__ void wgmma_ss_n8_mn_a(float (&d)[4], uint64_t da,
                                                 uint64_t db, int scale_d) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(scale_d));
#endif
}

// D[64 x 16] (+)= A[64 x 16] * B[16 x 16]; A MN-major (128-byte swizzle),
// B K-major (no swizzle), both from shared memory: wgmma_ss_n8_mn_a's
// product on two groups of 8 B rows at once.
__device__ __forceinline__ void wgmma_ss_n16_mn_a(float (&d)[8], uint64_t da,
                                                  uint64_t db, int scale_d) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
#endif
}

// mbarrier: a shared-memory barrier that completes a phase when its
// arrivals and its expected transaction bytes (the bytes a TMA copy
// delivers) are all in. Initialise with the arrival count, then make the
// initialisation visible to the async proxy before the first copy.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
#if defined(__CUDA_ARCH__)
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
#endif
}

__device__ __forceinline__ void fence_mbar_init() {
#if defined(__CUDA_ARCH__)
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#endif
}

// one arrival that also expects `bytes` more transaction bytes this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
      :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
#endif
}

// wait until the phase of parity `phase` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
#if defined(__CUDA_ARCH__)
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(phase) : "memory");
#endif
}

// TMA: copy the box at coordinates (c0, c1, c2) of a 3-D tensor map into
// shared memory at dst (laid out and swizzled as the map says); the bytes
// complete on bar's current phase. One thread issues it.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(map), "r"(smem_addr(bar)), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
#endif
}

// Host: a 3-D tensor map of the bf16 array w[E][K][Nw] (Nw contiguous),
// boxes of 64 columns x `rows` rows of one matrix, 128-byte swizzled in
// shared memory (the layout of stage_tile_sw128, one 64-column atom a
// box); boxes past K or Nw are zero-filled. The encoder,
// cuTensorMapEncodeTiled, is looked up through the runtime, so nothing
// links against libcuda.
inline cudaError_t make_tma_3d(CUtensorMap* map, const void* w, int E, int K,
                               int Nw, int rows) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
        cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || encode == nullptr)
      return cudaErrorNotSupported;
  }
  const cuuint64_t dims[3] = {(cuuint64_t)Nw, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)Nw * 2, (cuuint64_t)K * Nw * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Programmatic dependent launch. A primary kernel's blocks call
// launch_dependents to let the next kernel on the stream (launched with
// cudaLaunchAttributeProgrammaticStreamSerialization) start on SMs they
// free; that kernel calls wait before it reads what the primary wrote
// (it returns once the primary grid has completed and its writes are
// visible; at once when there is no primary).
__device__ __forceinline__ void griddep_launch_dependents() {
#if defined(__CUDA_ARCH__)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
#endif
}

__device__ __forceinline__ void griddep_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
#endif
}

// D[64 x 32] (+)= A[64 x 16] * B[16 x 32]; A from registers (the
// accumulator-shaped fragment), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
#endif
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64]; A from registers (the
// accumulator-shaped fragment), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
#endif
}

// D[64 x 80] (+)= A[64 x 16] * B[16 x 80]; A from registers (the
// accumulator-shaped fragment), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[40],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
#endif
}

// D[64 x 112] (+)= A[64 x 16] * B[16 x 112]; A from registers (the
// accumulator-shaped fragment), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[56],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
#endif
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128]; A from registers (the
// accumulator-shaped fragment), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
#endif
}

// D[64 x 256] (+)= A[64 x 16] * B[16 x 256]; A from registers (the
// accumulator-shaped fragment), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
#endif
}

}  // namespace sm90
}  // namespace repro
