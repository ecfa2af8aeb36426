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
// at the ridge, slightly on the side of the operations.  This first version
// keeps the score and dS tiles in registers and never writes a T x T matrix
// to device memory, so its traffic stays near the bound; it does the
// arithmetic on the CUDA cores in f32 (no tensor cores), like flash_fwd.cu,
// which puts it far above the operation bound.  mma/wgmma, TMA and one fused
// kernel with an atomic dQ are left to a later version.
//
// Design: the TPU kernels carry their accumulators across a sequential
// innermost grid axis; here a block owns its output tile and loops over the
// other axis itself, so no atomics are needed and the result is
// deterministic.
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

template <typename T, bool DQ>
cudaError_t launch_d(int D, const Args& a) {
  switch (D) {
    case 16: return DQ ? launch_dq<T, 16>(a) : launch_dkv<T, 16>(a);
    case 32: return DQ ? launch_dq<T, 32>(a) : launch_dkv<T, 32>(a);
    case 64: return DQ ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
    case 128: return DQ ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a);
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
