// Hopper (sm_90a) tile layer: TMA tensor maps and loads, mbarriers, wgmma
// shared-memory descriptors for 128-byte-swizzled bf16 tiles, the two forms of
// wgmma m64n64k16 (SS and RS) and the conversion of a float32 accumulator
// fragment into the bf16 A fragment of the next product.
//
// Every tile is 64 rows x 64 bf16 columns (128 bytes a row, 8 KB), written by one
// TMA load with CU_TENSOR_MAP_SWIZZLE_128B at a 1024-byte-aligned shared address:
// row r sits at r * 128 bytes, its 16-byte chunk c at chunk c ^ (r % 8). A wider
// operand (D = 128) is two such tiles side by side along its columns.
//
// Fragments of one warpgroup (128 threads; warp w = thread / 32 within the
// group, lane l): the m64n64 float32 accumulator gives each thread rows
// r = 16 w + l / 4 and r + 8, columns 8 j + 2 (l % 4) + {0, 1} for j < 8, in
// register 4 j + {0, 1} (row r) and 4 j + {2, 3} (row r + 8). The m64k16 bf16 A
// fragment of a register-sourced product holds the same rows at columns
// 2 (l % 4) + {0, 1} and + 8: so the accumulator's registers 8 kk .. 8 kk + 7,
// packed two at a time, are the A fragment of k-step kk (columns 16 kk ..
// 16 kk + 15), with no data moving between threads.
//
// Plain C++ and inline PTX, no CUTLASS: this header and the sources that include
// it build in seconds.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr int TILE = 64;                          // rows and bf16 columns of a tile
constexpr uint32_t TILE_BYTES = TILE * TILE * 2;  // 8 KB
constexpr uint32_t ROW_BYTES = 128;

// -- host: tensor maps -------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so that the
// library needs no -lcuda. -> null when the driver does not offer it.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                      cudaEnableDefault, &found);
#else
    cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                             &found);
#endif
    if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A map over the row-major bf16 matrix (rows, cols) at ptr, in 64 x 64 boxes
// with the 128-byte swizzle. -> 0, or a cudaError_t code.
inline int make_map(CUtensorMap* map, const void* ptr, uint64_t rows, uint64_t cols) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  if ((reinterpret_cast<uintptr_t>(ptr) & 15) || (cols * 2) % 16 || cols % TILE)
    return (int)cudaErrorMisalignedAddress;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {TILE, TILE};
  const cuuint32_t elem[2] = {1, 1};
  CUresult rc = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                    strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                    CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                    CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// -- device: shared addresses, mbarriers, TMA ----------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA) and to the
// other threads; follow with __syncthreads().
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also announces `bytes` of transactions to come.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spins until the barrier's phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One 64 x 64 box at (row, col) of the map into dst (1024-byte aligned),
// completing `bar`'s transactions.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int row, int col) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row)
      : "memory");
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) of contiguous memory.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// -- device: wgmma -------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte-swizzled tile (layout type 1):
// start address, leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

// K-major operand (its rows are M or N, the reduction runs along the 128-byte
// row): 8-row groups 1024 bytes apart. k-step kk (16 columns, 32 bytes) starts
// kk * 32 bytes further; the hardware swizzles on the address bits, so that
// holds inside the swizzled row.
__device__ __forceinline__ uint64_t desc_k(const void* tile, int kk) {
  return make_desc(smem_u32(tile) + 32 * kk, 16, 8 * ROW_BYTES);
}

// MN-major operand (its rows run along the reduction K, the 64 N columns along
// the row): groups of 8 K-rows 1024 bytes apart; k-step kk (16 rows) starts
// kk * 2048 bytes further.
__device__ __forceinline__ uint64_t desc_mn(const void* tile, int kk) {
  return make_desc(smem_u32(tile) + 16 * ROW_BYTES * kk, TILE_BYTES, 8 * ROW_BYTES);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across a
// wgmma fence, commit or wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define SM90_ACC32(d)                                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])

#define SM90_D32                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (+)= A B over one k-step, A and B from shared memory. TB = 1: B is MN-major.
// accumulate = 0 overwrites d.
template <int TB>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                       int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32
      ", %32, %33, p, 1, 1, 0, %35;\n\t}"
      : SM90_ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TB));
}

// d (+)= A B over one k-step, A from registers (a bf16 A fragment), B from
// shared memory. TB = 1: B is MN-major.
template <int TB>
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                       int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n\t}"
      : SM90_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
}

// Two floats -> one register of two bf16 (round to nearest even), lo first.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The float32 m64n64 accumulator -> the bf16 A fragments of its four k-steps.
__device__ __forceinline__ void acc_to_a(const float (&d)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// This thread's place in the m64n64 accumulator of its warpgroup: the first of
// its two rows (the other is 8 below) and the first of its column pairs.
__device__ __forceinline__ int frag_row(int t) { return 16 * (t / 32) + (t % 32) / 4; }
__device__ __forceinline__ int frag_col(int t) { return 2 * (t % 4); }

}  // namespace sm90
