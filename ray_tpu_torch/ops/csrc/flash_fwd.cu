// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel ray_tpu/ops/attention.py::_flash_kernel (launched
// by _flash_forward).  Same function: out = softmax(scale * Q K^T) V with an
// optional causal mask whose diagonal is aligned bottom-right
// (q_offset = Tk - Tq), plus lse = m + log(l) per query row, in f32 and in
// natural log (the backward rebuilds P from it).  Scores, the running max m,
// the denominator l and the output accumulator are f32; P is rounded to V's
// dtype before P.V while l sums the unrounded P, as the TPU kernel does.
//
// Two designs, chosen by dtype and head dim only (flash_fwd below; the
// Python wrapper states the same rule):
//
// flash_fwd_kernel_tc, bf16 with D = 64 or 128 (every model path): the
// tensor cores.  What bounds it on an H100: at the training shapes (GPT-2
// B*H = 72 heads, T = 1024, D = 64, causal) the work is 9.7 GFLOP against
// 38 MB of traffic, 9.8 us at the 989 TFLOP/s bf16 peak and 11.4 us at 3.35
// TB/s; at the serving shape (192 heads, T = 128) 0.4 GFLOP against 12.7 MB,
// memory bound at 3.8 us.  Both products therefore have to run on the tensor
// cores, and the copies have to overlap them.  One warpgroup (128 threads)
// owns a 64-row q tile; K/V come in tiles of 64 keys.
//   - S = Q K^T is wgmma m64n64k16 with Q and K in shared memory, both
//     D-major (K-major for wgmma); P is rounded to bf16 in registers and is
//     the register A operand of O += P V, V read as the transposed B operand
//     from its [keys, D] tile (flash_mma.cuh).
//   - K/V tiles are bf16 in a 2-stage ring in shared memory, in wgmma's
//     128-byte swizzle (no bank conflicts); tile j+1's cp.async copies are in
//     flight while tile j's products run.  Keys past Tk are zero-filled.
//   - The softmax runs on the accumulator registers in the base-2 domain
//     (scale * log2(e) folded into the scores, exp2f); the row max takes two
//     shuffles per row per tile, the row sum two per row at the end.
//   - Only tiles that cross the causal diagonal or the ragged end apply a
//     mask; the causal key loop ends at the last tile any row sees, and the
//     heaviest q tiles are launched first so that the triangle does not leave
//     SMs idle at the end.
//
// flash_fwd_kernel, f32 at any D and bf16 at D = 16 or 32: the CUDA cores,
// kept from the first version.  One block per (b*h, 64-row q tile), 256
// threads, 4 per q row; a thread owns the head dims d with d % 4 == lane.
// K and V tiles of 32 keys are staged in shared memory as f32; each score is
// a partial dot product reduced across the row's 4 lanes with shuffles.
// f32 stays here because TF32 tensor cores would round the inputs to 10
// mantissa bits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

constexpr int BLOCK_M = 64;                 // q rows per block
constexpr int BLOCK_N = 32;                 // keys per shared-memory tile
constexpr int LANES = 4;                    // threads per q row
constexpr int THREADS = BLOCK_M * LANES;    // 256
constexpr float NEG_INF = -1e30f;           // the reference's mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Tq, int Tk,
                 int64_t q_sb, int64_t q_sh, int64_t q_st,
                 int64_t k_sb, int64_t k_sh, int64_t k_st,
                 int64_t v_sb, int64_t v_sh, int64_t v_st,
                 float scale, int causal) {
  constexpr int DL = D / LANES;  // head dims owned by one thread
  __shared__ float ks[BLOCK_N][D];
  __shared__ float vs[BLOCK_N][D];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int row = tid / LANES, lane = tid % LANES;
  const int q_start = blockIdx.y * BLOCK_M;
  const int qi = q_start + row;
  const bool row_ok = qi < Tq;
  const int q_offset = Tk - Tq;

  const T* qp = q + b * q_sb + h * q_sh;
  const T* kp = k + b * k_sb + h * k_sh;
  const T* vp = v + b * v_sb + h * v_sh;

  float qr[DL], acc[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) {
    qr[i] = row_ok ? to_f32(qp[qi * q_st + i * LANES + lane]) : 0.f;
    acc[i] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  int k_end = Tk;
  if (causal) {  // last key any row of this tile sees, plus one
    const int last_q = min(q_start + BLOCK_M, Tq) - 1;
    k_end = min(Tk, q_offset + last_q + 1);
  }

  for (int k0 = 0; k0 < k_end; k0 += BLOCK_N) {
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = tid; idx < BLOCK_N * D; idx += THREADS) {
      const int j = idx / D, d = idx % D, kj = k0 + j;
      const bool ok = kj < Tk;
      ks[j][d] = ok ? to_f32(kp[kj * k_st + d]) : 0.f;
      vs[j][d] = ok ? to_f32(vp[kj * v_st + d]) : 0.f;
    }
    __syncthreads();

    float s[BLOCK_N];
    float tile_max = NEG_INF;
#pragma unroll
    for (int j = 0; j < BLOCK_N; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DL; ++i) part += qr[i] * ks[j][i * LANES + lane];
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      float sj = part * scale;
      const int kj = k0 + j;
      if (kj >= Tk) sj = -INFINITY;                        // ragged edge: p = 0
      else if (causal && kj > qi + q_offset) sj = NEG_INF;  // above the diagonal
      s[j] = sj;
      tile_max = fmaxf(tile_max, sj);
    }

    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BLOCK_N; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
      const float pv = to_f32(from_f32<T>(p));  // P in V's dtype for P.V
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[i] += pv * vs[j][i * LANES + lane];
    }
    l = l * alpha + psum;
    m = m_new;
  }

  if (row_ok) {
    T* op = o + ((int64_t)bh * Tq + qi) * D;
#pragma unroll
    for (int i = 0; i < DL; ++i) op[i * LANES + lane] = from_f32<T>(acc[i] / l);
    if (lane == 0) lse[(int64_t)bh * Tq + qi] = m + logf(l);
  }
}

// shared memory of the tensor-core kernel: Q and 2 stages of (K, V), [64, D]
// bf16 each, plus 1 KB to align the base for the swizzle
template <int D> constexpr int tc_smem_bytes() { return 5 * flash_mma::TILE * D * 2 + 1024; }

template <int D>
__global__ void __launch_bounds__(flash_mma::WG)
flash_fwd_kernel_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                    float* __restrict__ lse, int H, int Tq, int Tk,
                    int64_t q_sb, int64_t q_sh, int64_t q_st,
                    int64_t k_sb, int64_t k_sh, int64_t k_st,
                    int64_t v_sb, int64_t v_sh, int64_t v_st,
                    float scale, int causal) {
  using namespace flash_mma;
  constexpr int NB = D / 64;                  // 64-column blocks of the output
  constexpr uint32_t TB = TILE * D * 2;       // bytes of one [64, D] tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t qs = smem_base_1k(smem_raw);
  auto ks = [=](int stage) { return qs + (1 + 2 * stage) * TB; };  // stage: K, then V
  auto vs = [=](int stage) { return qs + (2 + 2 * stage) * TB; };

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q_start = (gridDim.y - 1 - blockIdx.y) * TILE;  // heaviest tiles first
  const int q_offset = Tk - Tq;
  const __nv_bfloat16* qp = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kp = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vp = v + b * v_sb + h * v_sh;

  int k_end = Tk;
  if (causal) k_end = min(Tk, q_offset + min(q_start + TILE, Tq));  // last key seen + 1
  const int n_tiles = (k_end + TILE - 1) / TILE;

  load_tile<D>(qs, qp, q_st, q_start, Tq, tid);
  load_tile<D>(ks(0), kp, k_st, 0, Tk, tid);
  load_tile<D>(vs(0), vp, v_st, 0, Tk, tid);
  cp_async_commit();

  const int r = acc_row(tid);
  const int last_key[2] = {q_start + r + q_offset, q_start + r + 8 + q_offset};
  const float sl2 = scale * LOG2E;
  float acc[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // m in the base-2 domain

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1, k0 = j * TILE;
    cp_async_wait<0>();
    fence_async_shared();
    __syncthreads();  // tile j is in; every thread is done with tile j - 1
    if (j + 1 < n_tiles) {
      load_tile<D>(ks(st ^ 1), kp, k_st, k0 + TILE, Tk, tid);
      load_tile<D>(vs(st ^ 1), vp, v_st, k0 + TILE, Tk, tid);
    }
    cp_async_commit();

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
    mma_abt<D>(s, qs, ks(st));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    const bool masked = k0 + TILE > Tk || (causal && k0 + TILE - 1 > q_start + q_offset);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int half = (i >> 1) & 1;
      float x = s[i] * sl2;
      if (masked) {
        const int kj = k0 + acc_col(tid, i);
        if (kj >= Tk) x = -INFINITY;                                // ragged end: p = 0
        else if (causal && kj > last_key[half]) x = NEG_INF;       // above the diagonal
      }
      s[i] = x;
      mx[half] = fmaxf(mx[half], x);
    }
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
      alpha[half] = exp2f(m[half] - mx[half]);
      m[half] = mx[half];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int half = (i >> 1) & 1;
      s[i] = exp2f(s[i] - m[half]);
      psum[half] += s[i];  // l sums the unrounded P
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) l[half] = l[half] * alpha[half] + psum[half];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[nb][i] *= alpha[(i >> 1) & 1];

    uint32_t a[4][4];
    to_a_frags(s, a);  // P in V's dtype
    fence_frags(a);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);
    wgmma_fence();
    mma_pv<D>(acc, a, vs(st));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);
  }

  float inv_l[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
    inv_l[half] = 1.f / l[half];
  }
  store_rows<D>(o + (int64_t)bh * Tq * D, acc, inv_l, q_start, Tq, tid);
  if (tid % 4 == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q_start + r + 8 * half;
      if (row < Tq) lse[(int64_t)bh * Tq + row] = m[half] * LN2 + logf(l[half]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                   int B, int H, int Tq, int Tk, const int64_t* st, float scale,
                   int causal, cudaStream_t stream) {
  dim3 grid(B * H, (Tq + BLOCK_M - 1) / BLOCK_M);
  flash_fwd_kernel<T, D><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), H, Tq, Tk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, void* lse,
                      int B, int H, int Tq, int Tk, const int64_t* st, float scale,
                      int causal, cudaStream_t stream) {
  constexpr int smem = tc_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel_tc<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int q_sizes[3] = {B, H, Tq}, k_sizes[3] = {B, H, Tk};
  if (!flash_mma::aligned16(q, st, q_sizes) || !flash_mma::aligned16(k, st + 3, k_sizes) ||
      !flash_mma::aligned16(v, st + 6, k_sizes))
    return cudaErrorInvalidValue;
  dim3 grid(B * H, (Tq + flash_mma::TILE - 1) / flash_mma::TILE);
  using bf16 = __nv_bfloat16;
  flash_fwd_kernel_tc<D><<<grid, flash_mma::WG, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), H, Tq, Tk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: [B, H, T, D] with unit stride on D and the given element strides
// (batch, head, time) for each; o: contiguous [B, H, Tq, D] in q's dtype;
// lse: contiguous [B, H, Tq] f32.  dtype 0 = float32, 1 = bfloat16.
// bf16 at D 64 or 128 takes the tensor-core kernel, which also needs 16-byte
// aligned rows (flash_mma::aligned16); everything else the CUDA-core one.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int H, int Tq, int Tk, int D,
                         int64_t q_sb, int64_t q_sh, int64_t q_st,
                         int64_t k_sb, int64_t k_sh, int64_t k_st,
                         int64_t v_sb, int64_t v_sh, int64_t v_st,
                         float scale, int causal, int dtype, void* stream) {
  const int64_t st[9] = {q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    switch (D) {
      case 16: err = launch<float, 16>(q, k, v, o, lse, B, H, Tq, Tk, st, scale, causal, s); break;
      case 32: err = launch<float, 32>(q, k, v, o, lse, B, H, Tq, Tk, st, scale, causal, s); break;
      case 64: err = launch<float, 64>(q, k, v, o, lse, B, H, Tq, Tk, st, scale, causal, s); break;
      case 128: err = launch<float, 128>(q, k, v, o, lse, B, H, Tq, Tk, st, scale, causal, s); break;
    }
  } else if (dtype == 1) {
    using bf16 = __nv_bfloat16;
    switch (D) {
      case 16: err = launch<bf16, 16>(q, k, v, o, lse, B, H, Tq, Tk, st, scale, causal, s); break;
      case 32: err = launch<bf16, 32>(q, k, v, o, lse, B, H, Tq, Tk, st, scale, causal, s); break;
      case 64: err = launch_tc<64>(q, k, v, o, lse, B, H, Tq, Tk, st, scale, causal, s); break;
      case 128: err = launch_tc<128>(q, k, v, o, lse, B, H, Tq, Tk, st, scale, causal, s); break;
    }
  }
  return static_cast<int>(err);
}
