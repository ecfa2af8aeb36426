// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernels in ray_tpu/ops/attention.py, both launched by
// _flash_backward:
//   flash_bwd_dq  <- _flash_dq_kernel:  dQ = sum_k dS K
//   flash_bwd_dkv <- _flash_dkv_kernel: dV = sum_q P^T dO,  dK = sum_q dS^T Q
// with P = exp(scale * Q K^T - LSE) rebuilt from the forward's logsumexp and
// dS = P * (dO V^T - Delta) * scale, Delta = rowsum(dO * O) computed by the
// caller.  The causal diagonal is aligned bottom-right (q_offset = Tk - Tq);
// masked pairs have P = 0, as exp(-1e30 - LSE) is in the reference.  Every
// product accumulates in f32; P is rounded to dO's dtype before P^T dO, dS to
// K's dtype before dS K and to Q's dtype before dS^T Q, as the TPU kernels
// round them.  Outputs are in the inputs' dtype.
//
// What bounds them on an H100 at the training shape (B*H = 72 heads,
// T = 1024, D = 64, bf16, causal): dQ reads q, k, v, dO and writes dq
// (~47.8 MB with lse and Delta, 14.3 us at 3.35 TB/s) and does three
// products over the ~T^2/2 visible pairs (S, dP, dS K: 14.5 GFLOP, 14.7 us at
// the 989 TFLOP/s bf16 tensor-core peak); dK/dV moves ~57.2 MB (17.1 us) and
// does four products (S, P^T dO, dP, dS^T Q: 19.3 GFLOP, 19.5 us).  Both sit
// at the ridge, slightly on the side of the operations, so both want the
// tensor cores.  Neither writes a T x T matrix to device memory.
//
// The TPU kernels carry their accumulators across a sequential innermost
// grid axis; here a block owns its output tile and loops over the other axis
// itself, so no atomics are needed and the result is deterministic.
//
// flash_bwd_dq_kernel_tc, bf16 with D = 64 or 128 (every model path): the
// tensor cores, on the skeleton of flash_fwd_kernel_tc (flash_mma.cuh).  One
// warpgroup owns a 64-row q tile; Q and dO are copied into shared memory
// once, lse and Delta into registers; K/V tiles of 64 keys come through a
// 2-stage cp.async ring, up to the last key any row sees when causal, the
// heaviest q tiles first.  S = Q K^T and dP = dO V^T are wgmma with both
// operands in shared memory; dS is formed on the accumulator registers
// (P = exp2 of the base-2 scaled scores minus the base-2 lse), rounded to
// bf16 there and fed as the register A operand of dQ += dS K, K read as the
// transposed B operand from its [keys, D] tile.
//
// flash_bwd_dkv_kernel_tc, bf16 with D = 64 or 128 (every model path),
// replaces _flash_dkv_kernel on the tensor cores.  Its bound is the dK/dV
// one above (57.2 MB, 19.3 GFLOP, both about 19.5 us at the GPT-2 shape), so
// all four products run as wgmma and the copies overlap them.  The same
// skeleton as dQ with the roles of q and k swapped: one warpgroup owns a
// 64-key tile; K and V are copied into shared memory once; Q and dO tiles of
// 64 rows, with their 64 lse and 64 Delta values (4-byte copies: a row of
// lse need not start on a 16-byte boundary), come through a 2-stage cp.async
// ring from the first q tile that sees key k_start when causal.  Key tile 0
// has the most q tiles and is launched first (the heaviest-first order).
// The kernel works on the transposed scores, so it needs no wgmma form
// beyond flash_mma.cuh's two: S^T = K Q^T and dP^T = V dO^T are SS products
// whose rows are keys and columns queries; P^T = exp2 of the base-2 scores
// minus the column's base-2 lse, and dS^T = P^T (dP^T - Delta) scale, are
// formed on the registers with lse and Delta read per column from shared
// memory; their 16-column slabs, rounded to bf16, are the register A
// operands of dV += P^T dO and dK += dS^T Q, with dO and Q read as the
// transposed B operand from their [q rows, D] tiles.  S^T and dP^T go out in
// one commit group and dV and dK in the next, as dQ does: P stays in f32 for
// dS, as _flash_dkv_kernel computes it, and the peak is the dK/dV
// accumulators (64 or 128 floats) plus two score tiles (64); at D 64 that
// fits 3 blocks per SM (see the kernel's launch bounds).  Issuing S^T
// alone and overlapping dV with dP^T, as FlashAttention-2 orders its loop,
// would keep P's f32 tile and its bf16 fragments live across dP^T: 16
// registers more.  Masks apply only on tiles that cross the diagonal or a
// ragged end (keys >= Tk, queries >= Tq, key > q + q_offset), and set P = 0
// explicitly: a zero-filled lse past Tq would give P = 1.
//
// flash_bwd_dq_kernel and flash_bwd_dkv_kernel, f32 at any D and bf16 at
// D = 16 or 32: the CUDA cores, f32 arithmetic.
//   dQ:    one block per (b*h, 64-row q tile); loops over 32-key tiles of K
//          and V staged in shared memory (f32), up to the last key any row
//          of the tile sees when causal.
//   dK/dV: one block per (b*h, 64-key tile); loops over 32-row tiles of Q,
//          dO, LSE and Delta, from the first q tile that sees any key of the
//          tile when causal (_block_visible with q innermost).
// 256 threads, 4 per owned row.  A thread owns the head dims d with
// d % 4 == lane, so the 4 lanes of a row read 4 neighbouring shared-memory
// words (no bank conflicts; the 8 rows of a warp read the same words as a
// broadcast); each dot product is reduced over the 4 lanes with shuffles.
// Rows past Tq and keys past Tk are masked inside the kernels, so any Tq and
// Tk work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "flash_mma.cuh"

namespace {

constexpr int BLOCK_M = 64;                 // rows a block owns
constexpr int BLOCK_N = 32;                 // rows of the other axis per tile
constexpr int LANES = 4;                    // threads per owned row
constexpr int THREADS = BLOCK_M * LANES;    // 256

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back: the cast the TPU kernels make before a product
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// the dot product of a row held by the 4 lanes (DL dims each) with a
// shared-memory row, reduced over the lanes
template <int DL>
__device__ __forceinline__ float row_dot(const float (&r)[DL], const float* s, int lane) {
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < DL; ++i) part += r[i] * s[i * LANES + lane];
  part += __shfl_xor_sync(0xffffffffu, part, 1);
  part += __shfl_xor_sync(0xffffffffu, part, 2);
  return part;
}

struct Strides {  // element strides (batch, head, time) of q, k, v, dO
  int64_t q[3], k[3], v[3], o[3];
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int H, int Tq, int Tk, Strides st,
                    float scale, int causal) {
  constexpr int DL = D / LANES;
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

  const T* qp = q + b * st.q[0] + h * st.q[1];
  const T* kp = k + b * st.k[0] + h * st.k[1];
  const T* vp = v + b * st.v[0] + h * st.v[1];
  const T* op = dout + b * st.o[0] + h * st.o[1];

  float qr[DL], dor[DL], acc[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) {
    const int d = i * LANES + lane;
    qr[i] = row_ok ? to_f32(qp[qi * st.q[2] + d]) : 0.f;
    dor[i] = row_ok ? to_f32(op[qi * st.o[2] + d]) : 0.f;
    acc[i] = 0.f;
  }
  const float row_lse = row_ok ? lse[(int64_t)bh * Tq + qi] : 0.f;
  const float row_delta = row_ok ? delta[(int64_t)bh * Tq + qi] : 0.f;

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
      ks[j][d] = ok ? to_f32(kp[kj * st.k[2] + d]) : 0.f;
      vs[j][d] = ok ? to_f32(vp[kj * st.v[2] + d]) : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BLOCK_N; ++j) {
      const float s = row_dot(qr, ks[j], lane) * scale;
      const float dp = row_dot(dor, vs[j], lane);
      const int kj = k0 + j;
      const bool vis = row_ok && kj < Tk && !(causal && kj > qi + q_offset);
      const float p = vis ? expf(s - row_lse) : 0.f;
      const float ds = round_to<T>(p * (dp - row_delta) * scale);  // dS in K's dtype
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[i] += ds * ks[j][i * LANES + lane];
    }
  }

  if (row_ok) {
    T* dqp = dq + ((int64_t)bh * Tq + qi) * D;
#pragma unroll
    for (int i = 0; i < DL; ++i) dqp[i * LANES + lane] = from_f32<T>(acc[i]);
  }
}

constexpr float LOG2E = 1.4426950408889634f;

// shared memory of the tensor-core dQ kernel: Q, dO and 2 stages of (K, V),
// [64, D] bf16 each, plus 1 KB to align the base for the swizzle
template <int D> constexpr int dq_tc_smem_bytes() { return 6 * flash_mma::TILE * D * 2 + 1024; }

template <int D>
__global__ void __launch_bounds__(flash_mma::WG)
flash_bwd_dq_kernel_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int H, int Tq, int Tk, Strides st,
                       float scale, int causal) {
  using namespace flash_mma;
  constexpr int NB = D / 64;                  // 64-column blocks of dQ
  constexpr uint32_t TB = TILE * D * 2;       // bytes of one [64, D] tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t qs = smem_base_1k(smem_raw), dos = qs + TB;
  auto ks = [=](int stage) { return qs + (2 + 2 * stage) * TB; };  // stage: K, then V
  auto vs = [=](int stage) { return qs + (3 + 2 * stage) * TB; };

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q_start = (gridDim.y - 1 - blockIdx.y) * TILE;  // heaviest tiles first
  const int q_offset = Tk - Tq;
  const __nv_bfloat16* kp = k + b * st.k[0] + h * st.k[1];
  const __nv_bfloat16* vp = v + b * st.v[0] + h * st.v[1];

  int k_end = Tk;
  if (causal) k_end = min(Tk, q_offset + min(q_start + TILE, Tq));  // last key seen + 1
  const int n_tiles = (k_end + TILE - 1) / TILE;

  load_tile<D>(qs, q + b * st.q[0] + h * st.q[1], st.q[2], q_start, Tq, tid);
  load_tile<D>(dos, dout + b * st.o[0] + h * st.o[1], st.o[2], q_start, Tq, tid);
  load_tile<D>(ks(0), kp, st.k[2], 0, Tk, tid);
  load_tile<D>(vs(0), vp, st.v[2], 0, Tk, tid);
  cp_async_commit();

  const int r = acc_row(tid);
  float lse2[2], row_delta[2];
  int last_key[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q_start + r + 8 * half;
    const bool ok = row < Tq;
    lse2[half] = ok ? lse[(int64_t)bh * Tq + row] * LOG2E : 0.f;
    row_delta[half] = ok ? delta[(int64_t)bh * Tq + row] : 0.f;
    last_key[half] = row + q_offset;
  }
  const float sl2 = scale * LOG2E;
  float acc[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1, k0 = j * TILE;
    cp_async_wait<0>();
    fence_async_shared();
    __syncthreads();  // tile j is in; every thread is done with tile j - 1
    if (j + 1 < n_tiles) {
      load_tile<D>(ks(stage ^ 1), kp, st.k[2], k0 + TILE, Tk, tid);
      load_tile<D>(vs(stage ^ 1), vp, st.v[2], k0 + TILE, Tk, tid);
    }
    cp_async_commit();

    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    mma_abt<D>(s, qs, ks(stage));
    mma_abt<D>(dp, dos, vs(stage));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    const bool masked = k0 + TILE > Tk || (causal && k0 + TILE - 1 > q_start + q_offset);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int half = (i >> 1) & 1;
      float p = exp2f(s[i] * sl2 - lse2[half]);
      if (masked) {
        const int kj = k0 + acc_col(tid, i);
        if (kj >= Tk || (causal && kj > last_key[half])) p = 0.f;
      }
      s[i] = p * (dp[i] - row_delta[half]) * scale;  // dS, in f32
    }

    uint32_t a[4][4];
    to_a_frags(s, a);  // dS in K's dtype
    fence_frags(a);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);
    wgmma_fence();
    mma_pv<D>(acc, a, ks(stage));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);
  }

  const float one[2] = {1.f, 1.f};
  store_rows<D>(dq + (int64_t)bh * Tq * D, acc, one, q_start, Tq, tid);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int H, int Tq, int Tk,
                     Strides st, float scale, int causal) {
  constexpr int DL = D / LANES;
  __shared__ float qs[BLOCK_N][D];
  __shared__ float dos[BLOCK_N][D];
  __shared__ float lses[BLOCK_N];
  __shared__ float deltas[BLOCK_N];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int row = tid / LANES, lane = tid % LANES;
  const int k_start = blockIdx.y * BLOCK_M;
  const int kj = k_start + row;
  const bool key_ok = kj < Tk;
  const int q_offset = Tk - Tq;

  const T* qp = q + b * st.q[0] + h * st.q[1];
  const T* kp = k + b * st.k[0] + h * st.k[1];
  const T* vp = v + b * st.v[0] + h * st.v[1];
  const T* op = dout + b * st.o[0] + h * st.o[1];
  const float* lp = lse + (int64_t)bh * Tq;
  const float* deltap = delta + (int64_t)bh * Tq;

  float kr[DL], vr[DL], dk_acc[DL], dv_acc[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) {
    const int d = i * LANES + lane;
    kr[i] = key_ok ? to_f32(kp[kj * st.k[2] + d]) : 0.f;
    vr[i] = key_ok ? to_f32(vp[kj * st.v[2] + d]) : 0.f;
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }

  int q_begin = 0;
  if (causal) {  // first q row that sees key k_start, down to its tile
    q_begin = max(0, k_start - q_offset);
    q_begin -= q_begin % BLOCK_N;
  }

  for (int q0 = q_begin; q0 < Tq; q0 += BLOCK_N) {
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = tid; idx < BLOCK_N * D; idx += THREADS) {
      const int i = idx / D, d = idx % D, qi = q0 + i;
      const bool ok = qi < Tq;
      qs[i][d] = ok ? to_f32(qp[qi * st.q[2] + d]) : 0.f;
      dos[i][d] = ok ? to_f32(op[qi * st.o[2] + d]) : 0.f;
    }
    if (tid < BLOCK_N) {
      const int qi = q0 + tid;
      lses[tid] = qi < Tq ? lp[qi] : 0.f;
      deltas[tid] = qi < Tq ? deltap[qi] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int i = 0; i < BLOCK_N; ++i) {
      const float s = row_dot(kr, qs[i], lane) * scale;
      const float dp = row_dot(vr, dos[i], lane);
      const int qi = q0 + i;
      const bool vis = key_ok && qi < Tq && !(causal && kj > qi + q_offset);
      const float p = vis ? expf(s - lses[i]) : 0.f;
      const float pr = round_to<T>(p);                                // P in dO's dtype
      const float ds = round_to<T>(p * (dp - deltas[i]) * scale);     // dS in Q's dtype
#pragma unroll
      for (int c = 0; c < DL; ++c) {
        const int d = c * LANES + lane;
        dv_acc[c] += pr * dos[i][d];
        dk_acc[c] += ds * qs[i][d];
      }
    }
  }

  if (key_ok) {
    const int64_t base = ((int64_t)bh * Tk + kj) * D;
#pragma unroll
    for (int c = 0; c < DL; ++c) {
      dk[base + c * LANES + lane] = from_f32<T>(dk_acc[c]);
      dv[base + c * LANES + lane] = from_f32<T>(dv_acc[c]);
    }
  }
}

// shared memory of the tensor-core dK/dV kernel: K, V and 2 stages of (Q,
// dO), [64, D] bf16 each; 2 stages of (lse, Delta), 64 f32 each; plus 1 KB to
// align the base for the swizzle
template <int D> constexpr int dkv_tc_smem_bytes() {
  return 6 * flash_mma::TILE * D * 2 + 2 * 2 * flash_mma::TILE * 4 + 1024;
}

// At D 64, 3 blocks per SM: ptxas then fits the kernel in 168 registers with
// a few bytes of spill, where left free it takes 176, which the register
// file holds only twice per SM; on an H100 the 3-block build ran faster at
// both training shapes.
template <int D>
__global__ void __launch_bounds__(flash_mma::WG, D == 64 ? 3 : 1)
flash_bwd_dkv_kernel_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H,
                        int Tq, int Tk, Strides st, float scale, int causal) {
  using namespace flash_mma;
  constexpr int NB = D / 64;                  // 64-column blocks of dK and dV
  constexpr uint32_t TB = TILE * D * 2;       // bytes of one [64, D] tile
  constexpr uint32_t RB = 2 * TILE * 4;       // bytes of one stage's lse and Delta
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ks = smem_base_1k(smem_raw), vs = ks + TB;
  auto qs = [=](int stage) { return ks + (2 + 2 * stage) * TB; };  // stage: Q, then dO
  auto dos = [=](int stage) { return ks + (3 + 2 * stage) * TB; };
  const uint32_t rows_s = ks + 6 * TB;        // stage: lse[64], then Delta[64]
  const float* rows = reinterpret_cast<const float*>(smem_raw + (rows_s - smem_u32(smem_raw)));

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k_start = blockIdx.y * TILE;      // key tile 0, the heaviest, first
  const int q_offset = Tk - Tq;
  const __nv_bfloat16* qp = q + b * st.q[0] + h * st.q[1];
  const __nv_bfloat16* op = dout + b * st.o[0] + h * st.o[1];
  // thread t copies row t of lse (t < 64) or row t - 64 of Delta of each q tile
  const float* rowp = (tid < TILE ? lse : delta) + (int64_t)bh * Tq;

  int q_begin = 0;
  if (causal) q_begin = max(0, k_start - q_offset) / TILE * TILE;  // first row seeing k_start
  const int n_tiles = (Tq - q_begin + TILE - 1) / TILE;

  auto load_q_tile = [&](int stage, int q0) {  // q tile q0 into a stage
    load_tile<D>(qs(stage), qp, st.q[2], q0, Tq, tid);
    load_tile<D>(dos(stage), op, st.o[2], q0, Tq, tid);
    const int row = q0 + tid % TILE;
    const bool ok = row < Tq;
    cp_async4(rows_s + stage * RB + tid * 4, rowp + (ok ? row : 0), ok);
  };
  load_tile<D>(ks, k + b * st.k[0] + h * st.k[1], st.k[2], k_start, Tk, tid);
  load_tile<D>(vs, v + b * st.v[0] + h * st.v[1], st.v[2], k_start, Tk, tid);
  if (n_tiles > 0) load_q_tile(0, q_begin);
  cp_async_commit();

  const int r = acc_row(tid);
  const float sl2 = scale * LOG2E;
  float dk_acc[NB][32], dv_acc[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[nb][i] = dv_acc[nb][i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1, q0 = q_begin + j * TILE;
    cp_async_wait<0>();
    fence_async_shared();
    __syncthreads();  // tile j is in; every thread is done with tile j - 1
    if (j + 1 < n_tiles) load_q_tile(stage ^ 1, q0 + TILE);
    cp_async_commit();

    float s[32], dp[32];  // S^T and dP^T: rows are keys, columns queries
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    mma_abt<D>(s, ks, qs(stage));
    mma_abt<D>(dp, vs, dos(stage));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    const bool masked = q0 + TILE > Tq || k_start + TILE > Tk ||
                        (causal && k_start + TILE - 1 > q0 + q_offset);
    const float* lse_s = rows + stage * 2 * TILE;
    const float* delta_s = lse_s + TILE;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {  // columns 8jj + 2(tid % 4) + e of d[4jj + 2half + e]
      const int c = 8 * jj + 2 * (tid % 4);
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c);
      const float2 d2 = *reinterpret_cast<const float2*>(delta_s + c);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float col_lse2 = (e ? l2.y : l2.x) * LOG2E;
        const float col_delta = e ? d2.y : d2.x;
        const int qi = q0 + c + e;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = 4 * jj + 2 * half + e;
          float p = exp2f(s[i] * sl2 - col_lse2);
          if (masked) {
            const int kj = k_start + r + 8 * half;
            if (kj >= Tk || qi >= Tq || (causal && kj > qi + q_offset)) p = 0.f;
          }
          dp[i] = p * (dp[i] - col_delta) * scale;  // dS^T, in f32
          s[i] = p;
        }
      }
    }

    uint32_t pa[4][4], da[4][4];
    to_a_frags(s, pa);   // P^T in dO's dtype
    to_a_frags(dp, da);  // dS^T in Q's dtype
    fence_frags(pa);
    fence_frags(da);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      fence_regs(dv_acc[nb]);
      fence_regs(dk_acc[nb]);
    }
    wgmma_fence();
    mma_pv<D>(dv_acc, pa, dos(stage));
    mma_pv<D>(dk_acc, da, qs(stage));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      fence_regs(dv_acc[nb]);
      fence_regs(dk_acc[nb]);
    }
  }

  const float one[2] = {1.f, 1.f};
  store_rows<D>(dk + (int64_t)bh * Tk * D, dk_acc, one, k_start, Tk, tid);
  store_rows<D>(dv + (int64_t)bh * Tk * D, dv_acc, one, k_start, Tk, tid);
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;  // dq; or dk and dv
  int B, H, Tq, Tk;
  Strides st;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  dim3 grid(a.B * a.H, (a.Tq + BLOCK_M - 1) / BLOCK_M);
  flash_bwd_dq_kernel<T, D><<<grid, THREADS, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.out0), a.H, a.Tq, a.Tk,
      a.st, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  dim3 grid(a.B * a.H, (a.Tk + BLOCK_M - 1) / BLOCK_M);
  flash_bwd_dkv_kernel<T, D><<<grid, THREADS, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.out0), static_cast<T*>(a.out1),
      a.H, a.Tq, a.Tk, a.st, a.scale, a.causal);
  return cudaGetLastError();
}

// the rows of q, k, v and dO start on 16-byte boundaries, as the tensor-core
// kernels' cp.async copies need
bool tc_rows_aligned(const Args& a) {
  const int q_sizes[3] = {a.B, a.H, a.Tq}, k_sizes[3] = {a.B, a.H, a.Tk};
  return flash_mma::aligned16(a.q, a.st.q, q_sizes) &&
         flash_mma::aligned16(a.k, a.st.k, k_sizes) &&
         flash_mma::aligned16(a.v, a.st.v, k_sizes) &&
         flash_mma::aligned16(a.dout, a.st.o, q_sizes);
}

template <int D>
cudaError_t launch_dq_tc(const Args& a) {
  constexpr int smem = dq_tc_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel_tc<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (!tc_rows_aligned(a)) return cudaErrorInvalidValue;
  dim3 grid(a.B * a.H, (a.Tq + flash_mma::TILE - 1) / flash_mma::TILE);
  using bf16 = __nv_bfloat16;
  flash_bwd_dq_kernel_tc<D><<<grid, flash_mma::WG, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const bf16*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<bf16*>(a.out0), a.H, a.Tq, a.Tk,
      a.st, a.scale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_tc(const Args& a) {
  constexpr int smem = dkv_tc_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel_tc<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (!tc_rows_aligned(a)) return cudaErrorInvalidValue;
  dim3 grid(a.B * a.H, (a.Tk + flash_mma::TILE - 1) / flash_mma::TILE);
  using bf16 = __nv_bfloat16;
  flash_bwd_dkv_kernel_tc<D><<<grid, flash_mma::WG, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<const bf16*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<bf16*>(a.out0), static_cast<bf16*>(a.out1),
      a.H, a.Tq, a.Tk, a.st, a.scale, a.causal);
  return cudaGetLastError();
}

// bf16 at D 64 or 128 takes the tensor-core kernels; f32 and bf16 at D 16 or
// 32 the CUDA-core ones
template <typename T, bool DQ, int D>
cudaError_t launch_one(const Args& a) {
  constexpr bool tc = std::is_same<T, __nv_bfloat16>::value && (D == 64 || D == 128);
  if constexpr (DQ && tc) return launch_dq_tc<D>(a);
  else if constexpr (DQ) return launch_dq<T, D>(a);
  else if constexpr (tc) return launch_dkv_tc<D>(a);
  else return launch_dkv<T, D>(a);
}

template <typename T, bool DQ>
cudaError_t launch_d(int D, const Args& a) {
  switch (D) {
    case 16: return launch_one<T, DQ, 16>(a);
    case 32: return launch_one<T, DQ, 32>(a);
    case 64: return launch_one<T, DQ, 64>(a);
    case 128: return launch_one<T, DQ, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool DQ>
int launch(int dtype, int D, const Args& a) {
  cudaError_t err;
  if (dtype == 0)
    err = launch_d<float, DQ>(D, a);
  else if (dtype == 1)
    err = launch_d<__nv_bfloat16, DQ>(D, a);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

Strides make_strides(int64_t q_sb, int64_t q_sh, int64_t q_st, int64_t k_sb, int64_t k_sh,
                     int64_t k_st, int64_t v_sb, int64_t v_sh, int64_t v_st, int64_t o_sb,
                     int64_t o_sh, int64_t o_st) {
  return Strides{{q_sb, q_sh, q_st}, {k_sb, k_sh, k_st}, {v_sb, v_sh, v_st}, {o_sb, o_sh, o_st}};
}

}  // namespace

// q, dout: [B, H, Tq, D]; k, v: [B, H, Tk, D]; each with unit stride on D and
// the given element strides (batch, head, time).  lse, delta: contiguous
// [B, H, Tq] f32.  dq: contiguous [B, H, Tq, D]; dk, dv: contiguous
// [B, H, Tk, D]; all in the inputs' dtype (0 = float32, 1 = bfloat16).
// Both take the tensor-core kernel in bf16 at D 64 or 128, which also needs
// 16-byte aligned rows (flash_mma::aligned16).
// Each returns the cudaError_t of its launch (0 on success).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq,
                            int B, int H, int Tq, int Tk, int D,
                            int64_t q_sb, int64_t q_sh, int64_t q_st,
                            int64_t k_sb, int64_t k_sh, int64_t k_st,
                            int64_t v_sb, int64_t v_sh, int64_t v_st,
                            int64_t o_sb, int64_t o_sh, int64_t o_st,
                            float scale, int causal, int dtype, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, B, H, Tq, Tk,
               make_strides(q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st,
                            o_sb, o_sh, o_st),
               scale, causal, static_cast<cudaStream_t>(stream)};
  return launch<true>(dtype, D, a);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv,
                             int B, int H, int Tq, int Tk, int D,
                             int64_t q_sb, int64_t q_sh, int64_t q_st,
                             int64_t k_sb, int64_t k_sh, int64_t k_st,
                             int64_t v_sb, int64_t v_sh, int64_t v_st,
                             int64_t o_sb, int64_t o_sh, int64_t o_st,
                             float scale, int causal, int dtype, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk,
               make_strides(q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st,
                            o_sb, o_sh, o_st),
               scale, causal, static_cast<cudaStream_t>(stream)};
  return launch<false>(dtype, D, a);
}
