// Tensor-core building blocks shared by flash_fwd.cu and flash_bwd.cu (sm_90a):
// cp.async copies of bf16 tiles into shared memory in the 128-byte swizzle
// that wgmma's descriptors read, the descriptors themselves, and the two
// wgmma forms the flash kernels use (m64n64k16, bf16 in, f32 accumulate):
//   ss:    D (+)= A B^T, A [64 x 16] and B [64 x 16] both read from shared
//          memory, both K-major (the contraction dim contiguous): S = Q K^T
//          and dP = dO V^T, and their transposes S^T = K Q^T, dP^T = V dO^T.
//   rs_tb: D += A B, A [64 x 16] in registers (a P or dS tile), B [16 x 64]
//          read from shared memory stored MN-major (a [rows, D] tile of V,
//          K, dO or Q read with wgmma's transpose bit): O += P V,
//          dQ += dS K, dV += P^T dO and dK += dS^T Q.
//
// Tiles: a [64 rows, D] bf16 tile is D/64 blocks of [64 rows][64 cols]; each
// block row is 128 bytes, and 16-byte chunk c of row r lies at chunk
// c ^ (r % 8) (CUTLASS's Swizzle<3,4,3>), so the 8 rows of a swizzle atom
// (1 KB) put any one column in 8 different bank groups.  Tile bases are 1 KB
// aligned, which the swizzle needs.
//
// Register layouts (PTX ISA, wgmma m64nNk16): thread t of the warpgroup, warp
// w = t / 32, lane l.  The f32 accumulator of a [64, 64] tile is 32 floats:
// d[4j + e] holds row 16w + l/4 + 8(e/2), column 8j + 2(l%4) + e%2.  A bf16
// A fragment of a [64, 16] slab is 4 registers of 2 bf16: a[0] row 16w + l/4,
// columns 2(l%4) + {0, 1}; a[1] row + 8; a[2] columns + 8; a[3] both.  So
// accumulator columns 16k..16k+15 (d[8k .. 8k+7]) packed pairwise are the A
// fragment of k-slab k: P and dS go from the score accumulators to the next
// product without a trip through shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_mma {

constexpr int TILE = 64;             // q rows of a block, keys of a k/v tile
constexpr int WG = 128;              // one warpgroup
constexpr int BLOCK_BYTES = TILE * 128;  // one [64][64] bf16 block: 8 KB

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c (8 bf16, c < D/8) of row r in a swizzled tile
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return (c >> 3) * BLOCK_BYTES + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// 16 bytes global -> shared, asynchronous; zero-filled when !valid (src must
// still be a mapped address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
// 4 bytes global -> shared (one f32 of a row vector such as lse, whose rows
// need not start on a 16-byte boundary), zero-filled when !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// makes this thread's completed shared-memory writes visible to wgmma,
// which reads through the async proxy
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows row0 .. row0+63 of a [T, D] bf16 matrix with row stride `st`
// (elements; D contiguous) into the swizzled tile at `dst`; rows >= n_rows
// are zero.  All 128 threads take part; 16 bytes a thread a copy, 8
// neighbouring threads on one 128-byte row.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src,
                                          int64_t st, int row0, int n_rows, int tid) {
  constexpr int CHUNKS = D / 8;
#pragma unroll
  for (int it = 0; it < TILE * CHUNKS / WG; ++it) {
    const int i = tid + it * WG, r = i / CHUNKS, c = i % CHUNKS, row = row0 + r;
    const bool ok = row < n_rows;
    cp_async16(dst + sw128(r, c), src + (ok ? row : 0) * st + c * 8, ok);
  }
}

// wgmma shared-memory matrix descriptor for a 128-byte-swizzled operand:
// start address, leading and stride byte offsets (in 16-byte units) and the
// swizzle mode (1 = 128 B) in bits 62-63.  SBO is the distance between
// 8-row groups (1 KB).  LBO: unused by a K-major operand that reads 32 bytes
// of each 128-byte row; for the MN-major B of rs_tb (N = 64 = one swizzle
// atom wide) only the 8-row K groups repeat, 1 KB apart, so both offsets
// are set to 1 KB.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// pins the accumulator in registers at this point of the program: the
// compiler may not move reads or writes of it across a wgmma or its wait
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define FLASH_MMA_D32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31}"
#define FLASH_MMA_OUT32(d)                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),   \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),            \
  "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),            \
  "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),            \
  "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d = A B^T (accumulate == 0) or d += A B^T; A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FLASH_MMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FLASH_MMA_OUT32(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d += A B; A a register fragment, B MN-major in shared memory (transposed)
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FLASH_MMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FLASH_MMA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

#undef FLASH_MMA_D32
#undef FLASH_MMA_OUT32

// two f32 -> one register of two bf16 (lo in the low half), round to nearest
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragments of a [64, 64] f32 accumulator, rounded to bf16: one
// [64, 16] slab per k-step of the next product
__device__ __forceinline__ void to_a_frags(const float (&d)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    a[k][0] = pack_bf16(d[8 * k + 0], d[8 * k + 1]);
    a[k][1] = pack_bf16(d[8 * k + 2], d[8 * k + 3]);
    a[k][2] = pack_bf16(d[8 * k + 4], d[8 * k + 5]);
    a[k][3] = pack_bf16(d[8 * k + 6], d[8 * k + 7]);
  }
}

__device__ __forceinline__ void fence_frags(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i]) :: "memory");
}

// S-type product over the full head dim: d = A_tile B_tile^T, both [64, D]
// K-major swizzled tiles (D/16 k-steps; a k-step is 32 bytes into a 128-byte
// row, a 64-column block is BLOCK_BYTES further)
template <int D>
__device__ __forceinline__ void mma_abt(float (&d)[32], uint32_t a_tile, uint32_t b_tile) {
#pragma unroll
  for (int k = 0; k < D / 16; ++k) {
    const uint32_t off = (k >> 2) * BLOCK_BYTES + (k & 3) * 32;
    wgmma_ss(d, sw128_desc(a_tile + off), sw128_desc(b_tile + off), k > 0);
  }
}

// O-type product: acc[nb] += frags . tile[:, 64 nb : 64 nb + 64] for a [64
// rows, D] swizzled tile (4 k-steps of 16 rows, 2 KB apart)
template <int D>
__device__ __forceinline__ void mma_pv(float (&acc)[D / 64][32], const uint32_t (&a)[4][4],
                                       uint32_t tile) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int nb = 0; nb < D / 64; ++nb)
      wgmma_rs_tb(acc[nb], a[k], sw128_desc(tile + nb * BLOCK_BYTES + k * 2048));
}

// the dynamic shared memory rounded up to the next 1 KB (the launch asks
// for 1 KB more than the tiles need)
__device__ __forceinline__ uint32_t smem_base_1k(const void* raw) {
  return (smem_u32(raw) + 1023u) & ~1023u;
}

// rows of an accumulator this thread holds: r and r + 8
__device__ __forceinline__ int acc_row(int tid) { return (tid / 32) * 16 + (tid % 32) / 4; }
// column of d[4j + e] within its tile
__device__ __forceinline__ int acc_col(int tid, int i) {
  return (i >> 2) * 8 + (tid % 4) * 2 + (i & 1);
}

// Stores rows r, r + 8 of a [64, D] f32 accumulator as bf16 (scaled per row)
// into the contiguous [T, D] output at rows row0 + ..., those < n_rows.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[D / 64][32],
                                           const float (&mul)[2], int row0, int n_rows,
                                           int tid) {
  const int r = acc_row(tid);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + r + 8 * half;
    if (row >= n_rows) continue;
    __nv_bfloat16* p = out + (int64_t)row * D;
#pragma unroll
    for (int nb = 0; nb < D / 64; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = 4 * j + 2 * half;
        *reinterpret_cast<__nv_bfloat162*>(p + nb * 64 + acc_col(tid, i)) =
            __floats2bfloat162_rn(acc[nb][i] * mul[half], acc[nb][i + 1] * mul[half]);
      }
  }
}

// What the tensor-core kernels need of a strided [B, H, T, D] bf16 operand:
// a 16-byte aligned base and batch/head/time strides of whole 16-byte
// chunks, so every row starts on a cp.async boundary.  Strides of a dim of
// size 1 are never multiplied by a nonzero index and are not checked.
inline bool aligned16(const void* p, const int64_t* strides, const int* sizes) {
  if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (int i = 0; i < 3; ++i)
    if (sizes[i] > 1 && strides[i] % 8) return false;
  return true;
}

}  // namespace flash_mma
