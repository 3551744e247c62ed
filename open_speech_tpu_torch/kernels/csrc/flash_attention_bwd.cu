// Flash attention backward for Hopper (sm_90a): dQ, dK and dV of K1.
//
// Replaces no TPU kernel. The JAX package has no backward kernel and no
// custom_vjp: `jax.grad` differentiates `mha_reference`
// (`open_speech_tpu/ops/attention.py`), which materialises [Tq, Tk] per
// head. This file is K1's gradient for fine-tuning (`train.py`), with K1's
// exact semantics: logits = (q . k) * scale, optional end-aligned causal
// mask (row i sees keys j <= i + Tk - Tq), and rows with no visible key
// give zero output and contribute zero gradient. q, dO [B,H,Tq,D] and
// k, v [B,H,Tk,D], contiguous, one dtype (f32 or bf16), D in {32, 64}, any
// Tq and Tk; dq, dk, dv in the input dtype; every product accumulates in
// f32.
//
// The forward kernel (flash_attention.cu) is left as it is and keeps no
// log-sum-exp, so the backward recomputes what it needs. Three kernels,
// one launch each, no atomics (the result does not depend on the order the
// blocks run in):
//   0 `flash_bwd_prep`: one block per (b, h, 64 query rows), one pass
//     over the row's live kv tiles with an online max. lse2 = the row's
//     log2-sum-exp2 of scale * log2(e) * (q . k) over its visible keys
//     (+inf for a row with no key, so its probabilities come out 0), and
//     delta = sum_j P_j dP_j with dP = dO V^T, all in f32. That is
//     rowsum(dO * O) with O in f32: from the forward's bf16 O, delta's
//     rounding would not cancel in sum_j dS_j = 0, and dQ = dS K would
//     carry it times the keys' common component, which is large in a
//     cross-attention over layer-normed encoder states.
//   1 `flash_bwd_dkdv`: one block per (b, h, 64 keys), looping over the
//     query tiles that see any of its keys. With P = exp2(S' - lse2):
//     dV += P^T dO, dP = dO V^T, dS = P * (dP - delta), dK += dS^T Q.
//   2 `flash_bwd_dq`: one block per (b, h, 64 query rows), looping over
//     its live kv tiles: dQ += dS K.
//   dQ and dK take the softmax scale at the end. Causal tiles with no
//   visible pair are skipped in both loops.
//
// What bounds it on an H100 (989 TFLOP/s bf16 tensor cores, 67 TFLOP/s f32
// outside them, 3.35 TB/s): at the whisper encoder [1,20,1500,1500,64] the
// least work is 5 products of 2*B*H*Tq*Tk*D = 5.76 GFLOP each (28.8 GFLOP)
// against 26.9 MB of q, k, v, dO in and dq, dk, dv out: operations bound it
// (0.029 ms of tensor-core work vs 0.0080 ms of bytes in bf16).
//
// This first version is scalar f32 FMA: no tensor cores, 9 products instead
// of 5 (S and dP are recomputed in each kernel). Each block is 256
// threads over a 16 x 16 grid; a thread owns a 4 x 4 micro tile of each
// [64, 64] score tile (rows ty + 16 i, keys tx + 16 j) and a 4 x D/16 tile
// of each [64, D] product, so every shared-memory read is a broadcast or
// one word per bank. Tiles are held in shared memory as f32, rows padded
// by one word. wgmma and TMA are later work (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;        // query rows per tile
constexpr int kBN = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kR = 4;          // rows (and keys) of a tile per thread: 64 / 16

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* lse2;   // [B,H,Tq] log2-sum-exp2 of the row's scaled scores; +inf: no key
  float* delta;  // [B,H,Tq] sum_j P_j dP_j
  int H, Tq, Tk, causal;
  float scale;       // the softmax scale
  float scale_log2;  // scale * log2(e)
};

// the shared memory of the three kernels (the prep pass uses q, dout, k, v)
template <int D>
struct Tiles {
  float q[kBM][D + 1];
  float dout[kBM][D + 1];
  float k[kBN][D + 1];
  float v[kBN][D + 1];
  float p[kBM][kBN + 1];  // P, then dS
  float lse2[kBM];
  float delta[kBM];
};

// rows [r0, r0 + 64) of a [n, D] matrix into shared memory as f32; rows at
// or past n read as zeros
template <typename T, int D>
__device__ __forceinline__ void load_rows(float (*dst)[D + 1], const T* src, int r0, int n) {
  for (int i = threadIdx.x; i < 64 * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r][c] = r0 + r < n ? to_float(src[(size_t)(r0 + r) * D + c]) : 0.f;
  }
}

// each row's lse2 and delta; rows at or past Tq get +inf and 0, so their
// probabilities are 0
__device__ __forceinline__ void load_stats(float* lse2_s, float* delta_s, const float* lse2,
                                           const float* delta, int q0, int Tq) {
  if (threadIdx.x < kBM) {
    const int r = q0 + threadIdx.x;
    lse2_s[threadIdx.x] = r < Tq ? lse2[r] : INFINITY;
    delta_s[threadIdx.x] = r < Tq ? delta[r] : 0.f;
  }
}

// s[i][j] = a[ty + 16 i] . b[tx + 16 j] over D
template <int D>
__device__ __forceinline__ void dot_tile(const float (*a)[D + 1], const float (*b)[D + 1],
                                         float (&s)[kR][kR]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kR; ++j) s[i][j] = 0.f;
#pragma unroll 16
  for (int d = 0; d < D; ++d) {
    float x[kR], y[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) x[i] = a[ty + 16 * i][d];
#pragma unroll
    for (int j = 0; j < kR; ++j) y[j] = b[tx + 16 * j][d];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kR; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
  }
}

// key c is visible to query row r
__device__ __forceinline__ bool visible(int r, int c, const BwdArgs& a) {
  return c < a.Tk && (!a.causal || c <= r + a.Tk - a.Tq);
}

// raw scores of the tile (rows q0.., keys k0..) -> probabilities, 0 where
// masked or where the row has no key (lse2 = +inf)
__device__ __forceinline__ void probs(float (&s)[kR][kR], const float* lse2_s, int q0, int k0,
                                      const BwdArgs& a) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = q0 + ty + 16 * i;
    const float lse2 = lse2_s[ty + 16 * i];
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const int c = k0 + tx + 16 * j;
      s[i][j] = visible(r, c, a) ? exp2f(fmaf(s[i][j], a.scale_log2, -lse2)) : 0.f;
    }
  }
}

// acc[i][j] += sum_r p[r][ty + 16 i] * b[r][tx + 16 j]   (P^T B)
template <int D>
__device__ __forceinline__ void atb_tile(const float (*p)[kBN + 1], const float (*b)[D + 1],
                                         float (&acc)[kR][D / 16]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 8
  for (int r = 0; r < kBM; ++r) {
    float x[kR], y[D / 16];
#pragma unroll
    for (int i = 0; i < kR; ++i) x[i] = p[r][ty + 16 * i];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) y[j] = b[r][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// acc[i][j] += sum_c p[ty + 16 i][c] * b[c][tx + 16 j]   (P B)
template <int D>
__device__ __forceinline__ void ab_tile(const float (*p)[kBN + 1], const float (*b)[D + 1],
                                        float (&acc)[kR][D / 16]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 8
  for (int c = 0; c < kBN; ++c) {
    float x[kR], y[D / 16];
#pragma unroll
    for (int i = 0; i < kR; ++i) x[i] = p[ty + 16 * i][c];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) y[j] = b[c][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

template <int D>
__device__ __forceinline__ void zero(float (&acc)[kR][D / 16]) {
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
}

// rows r0 + ty + 16 i (those below n) of a [n, D] output, times mul
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[kR][D / 16], int r0, int n,
                                           float mul) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r < n) {
#pragma unroll
      for (int j = 0; j < D / 16; ++j) dst[(size_t)r * D + tx + 16 * j] = from_float<T>(acc[i][j] * mul);
    }
  }
}

// the sum (or max) over the 16 lanes that share a row (lanes 0-15 and 16-31
// of a warp are two rows)
__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off /= 2) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off /= 2) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// keys [0, end) that some row of the query tile starting at q0 sees
__device__ __forceinline__ int kv_end(int q0, const BwdArgs& a) {
  const int last = min(q0 + kBM, a.Tq) - 1;
  return a.causal ? min(max(last + a.Tk - a.Tq + 1, 0), a.Tk) : a.Tk;
}

// ── 0: lse2 and delta ────────────────────────────────────────────────────

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2) flash_bwd_prep(const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tiles<D>& t = *reinterpret_cast<Tiles<D>*>(smem_raw);

  const size_t bh = (size_t)blockIdx.z * a.H + blockIdx.y;
  const T* q = static_cast<const T*>(a.q) + bh * a.Tq * D;
  const T* k = static_cast<const T*>(a.k) + bh * a.Tk * D;
  const T* v = static_cast<const T*>(a.v) + bh * a.Tk * D;
  const T* dout = static_cast<const T*>(a.dout) + bh * a.Tq * D;
  const int q0 = blockIdx.x * kBM;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_rows<T, D>(t.q, q, q0, a.Tq);
  load_rows<T, D>(t.dout, dout, q0, a.Tq);
  // this thread's running max, sum of 2^(x - m) and sum of 2^(x - m) * dP
  // over its keys, per row
  float m[kR], l[kR], u[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    u[i] = 0.f;
  }
  const int end = kv_end(q0, a);
  for (int k0 = 0; k0 < end; k0 += kBN) {
    __syncthreads();  // Q and dO have landed; the previous K, V tiles are consumed
    load_rows<T, D>(t.k, k, k0, a.Tk);
    load_rows<T, D>(t.v, v, k0, a.Tk);
    __syncthreads();
    float s[kR][kR], dp[kR][kR];
    dot_tile<D>(t.q, t.k, s);
    dot_tile<D>(t.dout, t.v, dp);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int r = q0 + ty + 16 * i;
      float x[kR];
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        x[j] = visible(r, k0 + tx + 16 * j, a) ? s[i][j] * a.scale_log2 : -INFINITY;
        mx = fmaxf(mx, x[j]);
      }
      if (mx == -INFINITY) continue;  // no key of this tile for this thread's part of the row
      const float c = exp2f(m[i] - mx);  // m[i] = -inf: 0
      float sum = l[i] * c, dsum = u[i] * c;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const float e = exp2f(x[j] - mx);
        sum += e;
        dsum = fmaf(e, dp[i][j], dsum);
      }
      m[i] = mx;
      l[i] = sum;
      u[i] = dsum;
    }
  }
  float* lse2 = a.lse2 + bh * a.Tq;
  float* delta = a.delta + bh * a.Tq;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const float mx = max16(m[i]);
    const float c = m[i] == -INFINITY ? 0.f : exp2f(m[i] - mx);
    const float sum = sum16(l[i] * c), dsum = sum16(u[i] * c);
    const int r = q0 + ty + 16 * i;
    if (tx == 0 && r < a.Tq) {
      lse2[r] = sum > 0.f ? mx + log2f(sum) : INFINITY;
      delta[r] = sum > 0.f ? dsum / sum : 0.f;
    }
  }
}

// ── 1: dK and dV ─────────────────────────────────────────────────────────

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2) flash_bwd_dkdv(const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tiles<D>& t = *reinterpret_cast<Tiles<D>*>(smem_raw);

  const size_t bh = (size_t)blockIdx.z * a.H + blockIdx.y;
  const T* q = static_cast<const T*>(a.q) + bh * a.Tq * D;
  const T* k = static_cast<const T*>(a.k) + bh * a.Tk * D;
  const T* v = static_cast<const T*>(a.v) + bh * a.Tk * D;
  const T* dout = static_cast<const T*>(a.dout) + bh * a.Tq * D;
  const float* lse2 = a.lse2 + bh * a.Tq;
  const float* delta = a.delta + bh * a.Tq;
  const int k0 = blockIdx.x * kBN;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_rows<T, D>(t.k, k, k0, a.Tk);
  load_rows<T, D>(t.v, v, k0, a.Tk);
  float dk[kR][D / 16], dv[kR][D / 16];
  zero<D>(dk);
  zero<D>(dv);
  // the first query row that sees key k0 (causal), and its tile
  const int first = a.causal ? max(k0 - (a.Tk - a.Tq), 0) : 0;
  for (int q0 = first / kBM * kBM; q0 < a.Tq; q0 += kBM) {
    __syncthreads();  // the previous query tile is consumed (and K, V have landed)
    load_rows<T, D>(t.q, q, q0, a.Tq);
    load_rows<T, D>(t.dout, dout, q0, a.Tq);
    load_stats(t.lse2, t.delta, lse2, delta, q0, a.Tq);
    __syncthreads();
    float p[kR][kR], dp[kR][kR];
    dot_tile<D>(t.q, t.k, p);
    probs(p, t.lse2, q0, k0, a);
    dot_tile<D>(t.dout, t.v, dp);
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kR; ++j) t.p[ty + 16 * i][tx + 16 * j] = p[i][j];
    __syncthreads();
    atb_tile<D>(t.p, t.dout, dv);
    __syncthreads();  // every read of P is done
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kR; ++j)
        t.p[ty + 16 * i][tx + 16 * j] = p[i][j] * (dp[i][j] - t.delta[ty + 16 * i]);
    __syncthreads();
    atb_tile<D>(t.p, t.q, dk);
  }
  store_rows<T, D>(static_cast<T*>(a.dk) + bh * a.Tk * D, dk, k0, a.Tk, a.scale);
  store_rows<T, D>(static_cast<T*>(a.dv) + bh * a.Tk * D, dv, k0, a.Tk, 1.f);
}

// ── 2: dQ ────────────────────────────────────────────────────────────────

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2) flash_bwd_dq(const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tiles<D>& t = *reinterpret_cast<Tiles<D>*>(smem_raw);

  const size_t bh = (size_t)blockIdx.z * a.H + blockIdx.y;
  const T* q = static_cast<const T*>(a.q) + bh * a.Tq * D;
  const T* k = static_cast<const T*>(a.k) + bh * a.Tk * D;
  const T* v = static_cast<const T*>(a.v) + bh * a.Tk * D;
  const T* dout = static_cast<const T*>(a.dout) + bh * a.Tq * D;
  const int q0 = blockIdx.x * kBM;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_rows<T, D>(t.q, q, q0, a.Tq);
  load_rows<T, D>(t.dout, dout, q0, a.Tq);
  load_stats(t.lse2, t.delta, a.lse2 + bh * a.Tq, a.delta + bh * a.Tq, q0, a.Tq);
  float dq[kR][D / 16];
  zero<D>(dq);
  const int end = kv_end(q0, a);
  for (int k0 = 0; k0 < end; k0 += kBN) {
    __syncthreads();  // the previous kv tile and dS are consumed (and Q, dO have landed)
    load_rows<T, D>(t.k, k, k0, a.Tk);
    load_rows<T, D>(t.v, v, k0, a.Tk);
    __syncthreads();
    float p[kR][kR], dp[kR][kR];
    dot_tile<D>(t.q, t.k, p);
    probs(p, t.lse2, q0, k0, a);
    dot_tile<D>(t.dout, t.v, dp);
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kR; ++j)
        t.p[ty + 16 * i][tx + 16 * j] = p[i][j] * (dp[i][j] - t.delta[ty + 16 * i]);
    __syncthreads();
    ab_tile<D>(t.p, t.k, dq);
  }
  store_rows<T, D>(static_cast<T*>(a.dq) + bh * a.Tq * D, dq, q0, a.Tq, a.scale);
}

// ── host ────────────────────────────────────────────────────────────────

template <typename T, int D>
cudaError_t launch(int stage, const BwdArgs& a, int B, cudaStream_t s) {
  const dim3 rows((a.Tq + kBM - 1) / kBM, a.H, B);
  const dim3 keys((a.Tk + kBN - 1) / kBN, a.H, B);
  const auto kernel = stage == 0   ? flash_bwd_prep<T, D>
                      : stage == 1 ? flash_bwd_dkdv<T, D>
                                   : flash_bwd_dq<T, D>;
  constexpr int smem = sizeof(Tiles<D>);  // above the 48 KB of static shared memory
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  kernel<<<stage == 1 ? keys : rows, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// One of the three passes of K1's backward: stage 0 writes lse2 and delta
// ([B,H,Tq] f32 scratch), stage 1 dk and dv, stage 2 dq (both read lse2 and
// delta). dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 =
// launched).
extern "C" int os_flash_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* dout, void* dq, void* dk, void* dv,
                                      float* lse2, float* delta, int stage, int B,
                                      int H, int Tq, int Tk, int D, int dtype, float scale,
                                      int causal, void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || B > 65535 || H > 65535 || stage < 0 || stage > 2 ||
      (dtype != 0 && dtype != 1) || (D != 32 && D != 64) || lse2 == nullptr ||
      delta == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const BwdArgs a{q, k, v, dout, dq, dk, dv, lse2, delta, H, Tq, Tk, causal,
                  scale, scale * 1.4426950408889634f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return (int)(D == 64 ? launch<__nv_bfloat16, 64>(stage, a, B, s)
                         : launch<__nv_bfloat16, 32>(stage, a, B, s));
  }
  return (int)(D == 64 ? launch<float, 64>(stage, a, B, s) : launch<float, 32>(stage, a, B, s));
}
