// Decode attention for Hopper (sm_90a): one position's attention over a
// padded KV cache, read once.
//
// Replaces no TPU kernel. The JAX package's `decode_attention`
// (`open_speech_tpu/ops/attention.py`) is plain jnp, which XLA fuses into
// one masked-softmax-matvec that reads each cache entry once. Eager
// PyTorch has no such fusion: the port's plain version upcasts both caches
// to float32 (a copy of each), takes two cuBLAS GEMVs over the copies and
// runs the softmax in between, some 13 launches moving five times the
// caches' bytes. This kernel is that whole chain in one launch.
//
// q [B,H,Tq,D] (any Tq, strided, unit stride on D; float32 or bf16), caches
// [B,H,T,D] (unit stride on D, rows of D on T, strided on B and H; bf16 or
// float32), length [B] (int32 or int64, device memory). Row b attends to
// keys j < min(length[b], T); a length <= 0 softmaxes uniformly over all T
// keys (every logit masked to the same value, as the plain version does).
// Output [B,H,Tq,D] contiguous in q's dtype.
//
// What bounds it on an H100 (3.35 TB/s): bytes. At the batcher's cross
// attention, caches [64,20,1500,64] bf16, K and V are 0.49 GB and the
// products 0.25 GFLOP: 0.147 ms of bytes against 0.3 us of bf16 tensor-core
// work, 295 operations a byte below the line. So the design only moves
// bytes well:
//   - A block of four warps streams one (b, h) and, with splits, one range
//     of its keys; up to 8 query rows (Tq = 1 on the decode steps, the
//     folded beams on REST's cross attention) share the one read of K and
//     V. A longer q (the REST prefill's prompt over the cross cache, once a
//     request) takes one block per 8 rows. Only keys below the row's length
//     are read: the self cache's valid prefix, not its padding.
//   - Each thread loads 16 bytes of a key row (8 bf16 or 4 float32), so a
//     row of D is D / 8 (or D / 4) neighbouring threads and a warp reads
//     512 contiguous bytes per load; every thread has U key rows of K and
//     of V in flight before it computes (U = 4, or 2 with up to 8 rows).
//   - The logits, the running max and sum (online softmax, base 2, the
//     scale * log2(e) folded into q) and the P V accumulator stay in float32
//     registers; the probabilities are never rounded. A row's threads sum
//     its dot product with xor shuffles; the key lanes of a warp, then the
//     warps (through shared memory, in a fixed order), merge their (m, l,
//     O) with log-sum-exp weights.
//   - With splits > 1 (too few (b, h) to fill 132 SMs: REST at B = 1, the
//     Pocket LM), a block writes its unnormalised O, max m and sum l to the
//     float32 partials [B,S,H,Tq,D] and [B,S,H,Tq], the layout of K2's, and
//     `flash_combine` (flash_attention.cu) merges them. The split count is
//     the host's, from the shapes alone; a split past the length reads
//     nothing and writes m = -inf, l = 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;  // query rows of a block where Tq > 1

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;             // [B,H,Tq,D] in q's dtype, or with splits > 1 the f32 partial O [B,S,H,Tq,D]
  const void* len;     // [B] int32 or int64
  float* m_part;       // [B,S,H,Tq] max (log2 units), splits > 1 only
  float* l_part;       // [B,S,H,Tq] sum, splits > 1 only
  long long q_sb, q_sh, q_st;  // q's strides, elements
  long long k_sb, k_sh, v_sb, v_sh;
  int H, Tq, T, splits, split_keys, q_f32, len_i64;
  float scale_log2;    // scale * log2(e)
};

// 16 bytes of a key row as float32
template <typename KT>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const void* p, bool live, float (&x)[8]) {
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (live) u = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const void* p, bool live, float (&x)[4]) {
    float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live) u = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = u.x;
    x[1] = u.y;
    x[2] = u.z;
    x[3] = u.w;
  }
};

// merges (m2, l2, o2) into (m, l, o): log-sum-exp weights against the
// larger max; a side that saw no key (m = -inf) weighs 0
template <int E>
__device__ __forceinline__ void merge(float& m, float& l, float (&o)[E], float m2, float l2,
                                      const float (&o2)[E]) {
  const float mx = fmaxf(m, m2);
  const float ref = mx == -INFINITY ? 0.f : mx;
  const float a = exp2f(m - ref), b = exp2f(m2 - ref);
  l = l * a + l2 * b;
#pragma unroll
  for (int e = 0; e < E; ++e) o[e] = o[e] * a + o2[e] * b;
  m = mx;
}

template <int D, typename KT, int TQ>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const DecodeArgs a) {
  constexpr int E = Vec<KT>::kN;  // columns per thread
  constexpr int TPR = D / E;      // threads per key row
  constexpr int KPW = 32 / TPR;   // key rows per warp per load
  constexpr int U = TQ == 1 ? 4 : 2;
  constexpr int kStep = kWarps * KPW * U;  // keys per block step
  static_assert(TPR >= 1 && TPR <= 32 && 32 % TPR == 0, "D / E threads must tile a warp");

  __shared__ float sm_o[kWarps][TQ][D];
  __shared__ float sm_m[kWarps][TQ];
  __shared__ float sm_l[kWarps][TQ];

  const int split = blockIdx.x % a.splits, h = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x / a.splits * TQ;  // the block's first query row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / TPR, col = (lane % TPR) * E;
  const int tq = min(TQ, a.Tq - r0);

  long long n = a.len_i64 ? static_cast<const long long*>(a.len)[b]
                          : static_cast<const int*>(a.len)[b];
  const bool uniform = n <= 0;
  n = uniform ? a.T : min(n, (long long)a.T);
  const int lo = split * a.split_keys;
  const int hi = (int)min((long long)lo + a.split_keys, n);

  // q rows, scaled into base-2 logits
  float qf[TQ][E];
#pragma unroll
  for (int r = 0; r < TQ; ++r) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float x = 0.f;
      if (r < tq) {
        const long long at = b * a.q_sb + h * a.q_sh + (r0 + r) * a.q_st + col + e;
        x = a.q_f32 ? static_cast<const float*>(a.q)[at]
                    : __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[at]);
      }
      qf[r][e] = x * a.scale_log2;
    }
  }

  float m[TQ], l[TQ], o[TQ][E];
#pragma unroll
  for (int r = 0; r < TQ; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) o[r][e] = 0.f;
  }

  const KT* kb = static_cast<const KT*>(a.k) + b * a.k_sb + h * a.k_sh + col;
  const KT* vb = static_cast<const KT*>(a.v) + b * a.v_sb + h * a.v_sh + col;
  for (int j0 = lo; j0 < hi; j0 += kStep) {
    float kx[U][E], vx[U][E];
    bool live[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + (u * kWarps + warp) * KPW + grp;
      live[u] = j < hi;
      if (!uniform) Vec<KT>::load(kb + (long long)j * D, live[u], kx[u]);
      Vec<KT>::load(vb + (long long)j * D, live[u], vx[u]);
    }
#pragma unroll
    for (int r = 0; r < TQ; ++r) {
      if (r >= tq) break;
      float s[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float acc = 0.f;
        if (!uniform) {
#pragma unroll
          for (int e = 0; e < E; ++e) acc = fmaf(qf[r][e], kx[u][e], acc);
#pragma unroll
          for (int w = TPR / 2; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
        }
        s[u] = live[u] ? acc : -INFINITY;
      }
      float mx = m[r];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u]);
      const float ref = mx == -INFINITY ? 0.f : mx;
      const float corr = exp2f(m[r] - ref);
      l[r] *= corr;
#pragma unroll
      for (int e = 0; e < E; ++e) o[r][e] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = exp2f(s[u] - ref);
        l[r] += p;
#pragma unroll
        for (int e = 0; e < E; ++e) o[r][e] = fmaf(p, vx[u][e], o[r][e]);
      }
      m[r] = mx;
    }
  }

  // the warp's key lanes, then the warps
#pragma unroll
  for (int r = 0; r < TQ; ++r) {
    if (r >= tq) break;
#pragma unroll
    for (int w = TPR; w < 32; w <<= 1) {
      float o2[E];
#pragma unroll
      for (int e = 0; e < E; ++e) o2[e] = __shfl_xor_sync(0xffffffffu, o[r][e], w);
      const float m2 = __shfl_xor_sync(0xffffffffu, m[r], w);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[r], w);
      merge<E>(m[r], l[r], o[r], m2, l2, o2);
    }
    if (grp == 0) {
#pragma unroll
      for (int e = 0; e < E; ++e) sm_o[warp][r][col + e] = o[r][e];
      if (col == 0) {
        sm_m[warp][r] = m[r];
        sm_l[warp][r] = l[r];
      }
    }
  }
  __syncthreads();

  const long long row0 = ((long long)b * a.splits + split) * a.H + h;  // (b, split, h), Tq rows
  for (int i = threadIdx.x; i < tq * TPR; i += kThreads) {
    const int r = i / TPR, c = (i % TPR) * E;
    float mm = sm_m[0][r], ll = sm_l[0][r], oo[E];
#pragma unroll
    for (int e = 0; e < E; ++e) oo[e] = sm_o[0][r][c + e];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      float o2[E];
#pragma unroll
      for (int e = 0; e < E; ++e) o2[e] = sm_o[w][r][c + e];
      merge<E>(mm, ll, oo, sm_m[w][r], sm_l[w][r], o2);
    }
    const long long at = (row0 * a.Tq + r0 + r) * D + c;
    if (a.splits > 1) {
      float* op = static_cast<float*>(a.o) + at;
#pragma unroll
      for (int e = 0; e < E; ++e) op[e] = oo[e];
      if (c == 0) {
        a.m_part[row0 * a.Tq + r0 + r] = ll > 0.f ? mm : -INFINITY;
        a.l_part[row0 * a.Tq + r0 + r] = ll;
      }
      continue;
    }
    const float inv = ll > 0.f ? 1.f / ll : 0.f;
    if (a.q_f32) {
      float* op = static_cast<float*>(a.o) + at;
#pragma unroll
      for (int e = 0; e < E; ++e) op[e] = oo[e] * inv;
    } else {
      __nv_bfloat16* op = static_cast<__nv_bfloat16*>(a.o) + at;
#pragma unroll
      for (int e = 0; e < E; ++e) op[e] = __float2bfloat16_rn(oo[e] * inv);
    }
  }
}

template <int D, typename KT>
int launch(const DecodeArgs& a, int B, cudaStream_t s) {
  if (a.Tq == 1) {
    decode_attention_kernel<D, KT, 1><<<dim3(a.splits, a.H, B), kThreads, 0, s>>>(a);
  } else {
    const int chunks = (a.Tq + kRows - 1) / kRows;
    decode_attention_kernel<D, KT, kRows><<<dim3(a.splits * chunks, a.H, B), kThreads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

template <typename KT>
int launch_d(const DecodeArgs& a, int B, int D, cudaStream_t s) {
  switch (D) {
    case 16: return launch<16, KT>(a, B, s);
    case 32: return launch<32, KT>(a, B, s);
    case 64: return launch<64, KT>(a, B, s);
    case 128: return launch<128, KT>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,H,Tq,D] at element strides (q_sb, q_sh, q_st, 1), dtype q_dtype (0 =
// float32, 1 = bfloat16); k, v [B,H,T,D] at strides (k_sb, k_sh, D, 1) and
// (v_sb, v_sh, D, 1), 16-byte aligned, dtype cache_dtype; len [B] int32 (or
// int64 with len_i64) in device memory. With splits == 1, o is [B,H,Tq,D]
// contiguous in q's dtype; with splits > 1 split s takes keys [s *
// split_keys, (s + 1) * split_keys), o is the f32 partial O [B,S,H,Tq,D] and
// m_part, l_part [B,S,H,Tq] (os_flash_combine merges them). D in {16, 32,
// 64, 128}, Tq >= 1. Returns a cudaError_t (0 = launched).
extern "C" int os_decode_attention(const void* q, const void* k, const void* v, void* o,
                                   const void* len, float* m_part, float* l_part,
                                   long long q_sb, long long q_sh, long long q_st,
                                   long long k_sb, long long k_sh, long long v_sb,
                                   long long v_sh, int B, int H, int Tq, int T, int D,
                                   int cache_dtype, int q_dtype, int len_i64, int splits,
                                   int split_keys, float scale, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || Tq < 1 || T < 0 || splits < 1 ||
      (long long)splits * ((Tq + kRows - 1) / kRows) > 0x7fffffffLL || split_keys < 1 ||
      (long long)splits * split_keys < T ||
      (cache_dtype != 0 && cache_dtype != 1) || (q_dtype != 0 && q_dtype != 1) ||
      (splits > 1 && (m_part == nullptr || l_part == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const DecodeArgs a{q, k, v, o, len, m_part, l_part, q_sb, q_sh, q_st, k_sb, k_sh, v_sb, v_sh,
                     H, Tq, T, splits, split_keys, q_dtype == 0, len_i64 != 0,
                     scale * 1.4426950408889634f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return cache_dtype == 0 ? launch_d<float>(a, B, D, s) : launch_d<__nv_bfloat16>(a, B, D, s);
}
