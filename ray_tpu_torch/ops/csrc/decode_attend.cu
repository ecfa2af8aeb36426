// Decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces no TPU kernel: the JAX package's decode attention
// (ray_tpu/models/generate.py::_decode_attend) is two XLA einsums over the
// bf16 cache with f32 accumulation and a length mask.  This kernel was added
// because the plain PyTorch version copied the whole cache to f32 every step
// and ran the einsums as cuBLAS GEMVs over every position, masked or not.
//
// Function: one query row a slot.  For slot b and query head h, with
// kv = h / g the KV head it reads (g = H / KV query heads per KV head, GQA),
//   out[b, h] = sum_j softmax_j(scale * q[b, h] . k[b, kv, j]) v[b, kv, j]
// over the positions j = 0..pos[b] of the slot's cache.  Scores, the online
// softmax, P and the P.V sum are f32; the result is rounded once, to the
// cache's dtype.  Positions past pos[b] are never read: the plain version's
// mask gives them exp(-1e30 - m) = 0 in f32, the same arithmetic, and
// j <= pos[b] always holds for j = 0.  pos stays in device memory, so the
// host never waits for the device.
//
// What bounds it on an H100: bytes.  Each attended position brings one K
// row and one V row (256 bytes at bf16, dh 64) for 2 g dh multiply-adds
// each, about half an operation a byte against the ~295 the card needs
// before its tensor cores would bind.  The least time is the K and V of the
// attended positions over 3.35 TB/s: GPT-2 125M decoding 256 slots at 384
// positions on average reads 302 MB a layer, 90 us.
//
// How the design approaches that bound:
//   - One block serves one (slot, KV head) pair and all g query heads on
//     it, so each K and V byte is read once.  The grid is B * KV blocks,
//     from shapes the host knows, never from pos.  The position axis is not
//     split: at the decode-long cell's 3,084 pairs the card is full (one
//     block a pair read 0.1056 ms against an 86.5 us bound, 82%; two blocks
//     a pair gained 1.6%, four and eight lost 18% and 81%).
//   - Rows are read as 16-byte loads in the cache's own dtype: LPR lanes per
//     row (a power of two; lanes past dh idle), each row's loads contiguous
//     across the lanes.  A lane group issues U rows of K and of V before it
//     uses any, 2 U independent 16-byte loads in flight per thread.
//   - The softmax runs in the base-2 domain (scale * log2(e) folded into q,
//     exp2f); a row's score is reduced across its LPR lanes by shuffles.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;           // the reference's mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half(x); }

// the 16 bytes of one load as f32, element i at f[i]
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4], float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8], __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 is the high half of an f32
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8], __half) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __half2float(__ushort_as_half(static_cast<unsigned short>(w[i] & 0xffffu)));
    f[2 * i + 1] = __half2float(__ushort_as_half(static_cast<unsigned short>(w[i] >> 16)));
  }
}

// T: the cache's dtype; NCH: 16-byte chunks of a row per lane (2 only for
// f32 rows wider than 128); G: query heads per KV head the registers hold
// (g <= G at run time).  Dynamic shared memory: THREADS / lpr * G * (D + 2)
// floats, 40 KiB at most (bf16, D 8, G 8), under the 48 KiB a launch may
// take without opting in.
template <typename T, int NCH, int G>
__global__ void __launch_bounds__(THREADS)
decode_attend_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int64_t* __restrict__ pos,
                     T* __restrict__ out, int H, int KV, int S, int D, int g, int lpr,
                     int64_t q_sb, int64_t q_sh, int64_t k_sb, int64_t k_sh, int64_t k_ss,
                     int64_t v_sb, int64_t v_sh, int64_t v_ss, float scale) {
  constexpr int VEC = 16 / sizeof(T);       // elements in one 16-byte load
  constexpr int U = G * NCH <= 2 ? 4 : 2;   // rows a lane group loads before it uses any
  extern __shared__ float smem[];

  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int tid = threadIdx.x;
  const int lane = tid % lpr, grp = tid / lpr, n_grp = THREADS / lpr;
  const int n_chunks = D / VEC;

  // the positions 0..pos[b], clamped into the cache
  const int64_t p = pos[b];
  const int hi = p < 0 ? 1 : (p >= S ? S : static_cast<int>(p) + 1);

  const T* kp = k + b * k_sb + kvh * k_sh;
  const T* vp = v + b * v_sb + kvh * v_sh;

  // q of the pair's query heads, in the base-2 domain
  const float qscale = scale * LOG2E;
  float qf[G][NCH][VEC], acc[G][NCH][VEC], m[G], l[G];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    const T* qh = q + b * q_sb + static_cast<int64_t>(kvh * g + h) * q_sh;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int chunk = lane + c * lpr;
      const bool ok = h < g && chunk < n_chunks;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        qf[h][c][e] = ok ? to_f32(qh[chunk * VEC + e]) * qscale : 0.f;
        acc[h][c][e] = 0.f;
      }
    }
    m[h] = NEG_INF;
    l[h] = 0.f;
  }

  // hi is the block's own, so every lane runs the same iterations and the
  // shuffles below see all 32 lanes
  for (int j0 = 0; j0 < hi; j0 += n_grp * U) {
    uint4 kr[U][NCH], vr[U][NCH];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = j0 + u * n_grp + grp;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int chunk = lane + c * lpr;
        if (row < hi && chunk < n_chunks) {
          kr[u][c] = __ldg(reinterpret_cast<const uint4*>(kp + row * k_ss) + chunk);
          vr[u][c] = __ldg(reinterpret_cast<const uint4*>(vp + row * v_ss) + chunk);
        } else {
          kr[u][c] = make_uint4(0u, 0u, 0u, 0u);
          vr[u][c] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
    float s[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float part[G];
#pragma unroll
      for (int h = 0; h < G; ++h) part[h] = 0.f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        float kf[VEC];
        unpack(kr[u][c], kf, T());
#pragma unroll
        for (int h = 0; h < G; ++h)
#pragma unroll
          for (int e = 0; e < VEC; ++e) part[h] += qf[h][c][e] * kf[e];
      }
      const bool ok = j0 + u * n_grp + grp < hi;
#pragma unroll
      for (int h = 0; h < G; ++h) {
        for (int off = lpr >> 1; off > 0; off >>= 1)
          part[h] += __shfl_xor_sync(FULL, part[h], off);
        s[u][h] = ok ? part[h] : -INFINITY;  // a row past hi: p = 0
      }
    }
    float pr[U][G];
#pragma unroll
    for (int h = 0; h < G; ++h) {
      float mx = m[h];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][h]);
      const float alpha = exp2f(m[h] - mx);
      m[h] = mx;
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        pr[u][h] = exp2f(s[u][h] - mx);
        psum += pr[u][h];
      }
      l[h] = l[h] * alpha + psum;
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[h][c][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        float vf[VEC];
        unpack(vr[u][c], vf, T());
#pragma unroll
        for (int h = 0; h < G; ++h)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[h][c][e] += pr[u][h] * vf[e];
      }
  }

  // the lane groups' (m, l, acc) meet in shared memory, and the block
  // writes the pair's g output rows
  float* grp_ml = smem;
  float* grp_acc = grp_ml + n_grp * G * 2;
#pragma unroll
  for (int h = 0; h < G; ++h) {
    const int at = grp * G + h;
    if (lane == 0) {
      grp_ml[2 * at] = m[h];
      grp_ml[2 * at + 1] = l[h];
    }
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int chunk = lane + c * lpr;
      if (chunk < n_chunks)
#pragma unroll
        for (int e = 0; e < VEC; ++e) grp_acc[at * D + chunk * VEC + e] = acc[h][c][e];
    }
  }
  __syncthreads();
  for (int i = tid; i < g * D; i += THREADS) {
    const int h = i / D, d = i % D;
    float M = NEG_INF;
    for (int gi = 0; gi < n_grp; ++gi) M = fmaxf(M, grp_ml[2 * (gi * G + h)]);
    float L = 0.f, A = 0.f;
    for (int gi = 0; gi < n_grp; ++gi) {
      const int at = gi * G + h;
      const float w = exp2f(grp_ml[2 * at] - M);
      L += grp_ml[2 * at + 1] * w;
      A += grp_acc[at * D + d] * w;
    }
    out[(static_cast<int64_t>(b) * H + kvh * g) * D + i] = from_f32<T>(A / L);
  }
}

template <typename T, int NCH, int G>
cudaError_t launch(const void* q, const void* k, const void* v, const void* pos, void* out,
                   int B, int H, int KV, int S, int D, int lpr, const int64_t* st,
                   float scale, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(THREADS / lpr) * G * (D + 2) * sizeof(float);
  decode_attend_kernel<T, NCH, G><<<B * KV, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int64_t*>(pos), static_cast<T*>(out), H, KV, S, D, H / KV, lpr,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], scale);
  return cudaGetLastError();
}

template <typename T, int NCH>
cudaError_t launch_g(int G, const void* q, const void* k, const void* v, const void* pos,
                     void* out, int B, int H, int KV, int S, int D, int lpr,
                     const int64_t* st, float scale, cudaStream_t stream) {
  switch (G) {
    case 1: return launch<T, NCH, 1>(q, k, v, pos, out, B, H, KV, S, D, lpr, st, scale, stream);
    case 2: return launch<T, NCH, 2>(q, k, v, pos, out, B, H, KV, S, D, lpr, st, scale, stream);
    case 4: return launch<T, NCH, 4>(q, k, v, pos, out, B, H, KV, S, D, lpr, st, scale, stream);
    case 8: return launch<T, NCH, 8>(q, k, v, pos, out, B, H, KV, S, D, lpr, st, scale, stream);
  }
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p, const int64_t* st, int n, int itemsize) {
  if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (int i = 0; i < n; ++i)
    if ((st[i] * itemsize) % 16) return false;
  return true;
}

}  // namespace

// q: [B, H, 1, D] with unit stride on D (batch and head strides given);
// k, v: [B, KV, S, D] caches with unit stride on D, every row on a 16-byte
// boundary; pos: int64 [B] in device memory; out: contiguous [B, H, D] in
// the cache's dtype.  dtype 0 = float32, 1 = bfloat16, 2 = float16 (q, k,
// v and out alike).  D a multiple of 8 up to 256; H / KV at most 8.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int decode_attend(const void* q, const void* k, const void* v, const void* pos,
                             void* out, int B, int H, int KV, int S, int D,
                             int64_t q_sb, int64_t q_sh,
                             int64_t k_sb, int64_t k_sh, int64_t k_ss,
                             int64_t v_sb, int64_t v_sh, int64_t v_ss,
                             float scale, int dtype, void* stream) {
  if (B < 1 || KV < 1 || S < 1 || H % KV || D < 8 || D > 256 || D % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int g = H / KV;
  const int G = g <= 1 ? 1 : g <= 2 ? 2 : g <= 4 ? 4 : g <= 8 ? 8 : 0;
  const int itemsize = dtype == 0 ? 4 : 2;
  const int64_t st[8] = {q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  if (!G || dtype < 0 || dtype > 2 || !aligned16(k, st + 2, 3, itemsize) ||
      !aligned16(v, st + 5, 3, itemsize))
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = D / (16 / itemsize);
  int lpr = 1;
  while (lpr < chunks && lpr < 32) lpr <<= 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1)
    err = launch_g<__nv_bfloat16, 1>(G, q, k, v, pos, out, B, H, KV, S, D, lpr, st, scale, s);
  else if (dtype == 2)
    err = launch_g<__half, 1>(G, q, k, v, pos, out, B, H, KV, S, D, lpr, st, scale, s);
  else if (chunks <= 32)
    err = launch_g<float, 1>(G, q, k, v, pos, out, B, H, KV, S, D, lpr, st, scale, s);
  else
    err = launch_g<float, 2>(G, q, k, v, pos, out, B, H, KV, S, D, lpr, st, scale, s);
  return static_cast<int>(err);
}
