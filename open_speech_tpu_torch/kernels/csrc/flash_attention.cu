// Flash attention forward for Hopper (sm_90a): tiled online-softmax MHA.
//
// Replaces the Pallas TPU kernels of `open_speech_tpu/ops/attention.py`
// (`_flash_kernel` through `_flash_call`):
//   K1 `_flash_attention_tpu`: exactly `mha_reference` with kv_length=None;
//   K2 `_flash_attention_tpu_dyn`: the same with a per-example valid kv
//      prefix kv_len [B] (int32, device memory).
// q [B,H,Tq,D], k/v [B,H,Tk,D], contiguous, one dtype (f32 or bf16),
// D in {32, 64}; logits = (q . k) * scale; optional end-aligned causal mask
// (row i sees keys j <= i + Tk - Tq, Tk the padded length) and, for K2,
// keys j < kv_len[b]; rows with no visible key give zeros; output in the
// input dtype. Any Tq is accepted, including Tq < 8 (the decoder prefill of
// 1-3 prompt tokens).
//
// K2 is the same two kernels instantiated with kVarlen: each block reads
// its example's length once and cuts its kv loop bound there, so tiles past
// the length are neither copied nor computed (the Pallas dead-block DMA
// skip). Its caller, the streaming encoder block [1,20,128,1500,64] bf16
// at length L, moves 2*L*D*H*2 bytes of k/v (7.7 MB at L = 1500, ~2.3 us
// at 3.35 TB/s) for 4*H*128*L*D operations (~1.0 us at 989 TFLOP/s): it is
// bytes-bound, and with ceil(128/64) * 20 = 40 blocks it fills well under
// a third of the 132 SMs; a split-kv grid is later work.
//
// What bounds it: the whisper encoder call [1,20,1500,64] bf16 is
// 4*B*H*Tq*Tk*D = 11.5 GFLOP against 15.4 MB of q/k/v/o, i.e. ~11.6 us at
// 989 TFLOP/s (bf16 tensor cores) vs ~4.6 us at 3.35 TB/s: compute-bound,
// so the bf16 path puts both products on the tensor cores.
//
// Two kernels, one per dtype:
//   - bf16 (the served path): `flash_fwd_bf16`, warp-level tensor-core
//     products (mma.sync m16n8k16, f32 accumulate). A block of 4 warps owns
//     64 query rows, a warp owns 16. Q stays in registers as mma operand
//     fragments; K and V tiles of 64 keys are staged in padded shared
//     memory (V transposed, so both products read 32-bit operand pairs
//     without bank conflicts). The S = QK^T accumulators are masked,
//     exponentiated against the f32 running max and repacked in registers
//     as the bf16 A operand of O += PV (the C layout of two m16n8 tiles is
//     the A layout of one k16 step), so P never touches shared memory.
//     wgmma and TMA (Hopper's full tensor-core rate) are later work.
//   - f32: `flash_fwd_f32`, scalar FMAs so the result stays f32-exact
//     (tensor cores would round inputs to TF32). One thread owns one query
//     row, with q and the accumulator in registers; K/V tiles are read from
//     shared memory as float4 broadcasts.
// Both: grid (ceil(Tq/64), H, B), the TPU's sequential kv grid axis
// replaced by a loop inside the block; f32 running max, denominator and
// accumulator; the ragged tail masked in-kernel (no padding copies); causal
// tiles above the diagonal skipped by the loop bound, so they are neither
// copied nor computed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;  // query rows per block

// keys visible to query row r: [0, visible)
__device__ __forceinline__ int visible_keys(int r, int tk, int offs, int causal) {
  return causal ? min(max(r + offs + 1, 0), tk) : tk;
}

// ... of which the first `len` exist (K2); K1 has len == Tk by definition
template <bool kVarlen>
__device__ __forceinline__ int row_keys(int r, int tk, int len, int offs, int causal) {
  const int n = visible_keys(r, tk, offs, causal);
  return kVarlen ? min(n, len) : n;
}

// keys that exist for this block's example: Tk, or its valid prefix (K2)
template <bool kVarlen>
__device__ __forceinline__ int example_keys(const int* kv_len, int Tk) {
  return kVarlen ? min(max(kv_len[blockIdx.z], 0), Tk) : Tk;
}

// ── bf16: tensor cores ──────────────────────────────────────────────────

constexpr int kWarps = 4;    // 16 query rows each
constexpr int kTileK = 64;   // keys per shared-memory tile

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D, bool kVarlen>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
               const int* __restrict__ kv_len, int H, int Tq, int Tk, float scale,
               int causal) {
  // +8 pads: row strides of 144/80 bytes spread a fragment's 8 rows over
  // distinct banks
  __shared__ __align__(16) __nv_bfloat16 ks[kTileK][D + 8];  // [key][dim]
  __shared__ __align__(16) __nv_bfloat16 vt[D][kTileK + 8];  // [dim][key]

  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const __nv_bfloat16* qp = q + bh * (size_t)Tq * D;
  const __nv_bfloat16* kp = k + bh * (size_t)Tk * D;
  const __nv_bfloat16* vp = v + bh * (size_t)Tk * D;
  __nv_bfloat16* op = o + bh * (size_t)Tq * D;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment coordinates
  const int row0 = blockIdx.x * kBlockQ;
  const int wrow = row0 + warp * 16;
  const int r_lo = wrow + g, r_hi = wrow + g + 8;  // this thread's two rows
  const int offs = Tk - Tq;
  const int len = example_keys<kVarlen>(kv_len, Tk);
  const int kv_end = row_keys<kVarlen>(min(row0 + kBlockQ, Tq) - 1, Tk, len, offs, causal);
  const int warp_end =
      wrow < Tq ? row_keys<kVarlen>(min(wrow + 15, Tq - 1), Tk, len, offs, causal) : 0;
  const int n_lo = r_lo < Tq ? row_keys<kVarlen>(r_lo, Tk, len, offs, causal) : 0;
  const int n_hi = r_hi < Tq ? row_keys<kVarlen>(r_hi, Tk, len, offs, causal) : 0;

  // Q as A fragments: a0 (row g, cols 2t..), a1 (row g+8), a2/a3 (cols +8)
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    const int col = 16 * c + 2 * t;
    qa[c][0] = r_lo < Tq ? ld_u32(qp + (size_t)r_lo * D + col) : 0u;
    qa[c][1] = r_hi < Tq ? ld_u32(qp + (size_t)r_hi * D + col) : 0u;
    qa[c][2] = r_lo < Tq ? ld_u32(qp + (size_t)r_lo * D + col + 8) : 0u;
    qa[c][3] = r_hi < Tq ? ld_u32(qp + (size_t)r_hi * D + col + 8) : 0u;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

  for (int kv0 = 0; kv0 < kv_end; kv0 += kTileK) {
    __syncthreads();  // the previous tile is fully consumed
    // 16-byte loads; keys past Tk (K2: past the length) are zero-filled
    // (masked below, but V must not carry NaN garbage into 0 * p)
    for (int i = threadIdx.x; i < kTileK * D / 8; i += kWarps * 32) {
      const int kk = i / (D / 8), d0 = (i % (D / 8)) * 8;
      uint4 kx = make_uint4(0, 0, 0, 0), vx = make_uint4(0, 0, 0, 0);
      if (kv0 + kk < len) {
        kx = *reinterpret_cast<const uint4*>(kp + (size_t)(kv0 + kk) * D + d0);
        vx = *reinterpret_cast<const uint4*>(vp + (size_t)(kv0 + kk) * D + d0);
      }
      *reinterpret_cast<uint4*>(&ks[kk][d0]) = kx;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vx);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt[d0 + e][kk] = ve[e];
    }
    __syncthreads();
    if (kv0 >= warp_end) continue;  // warp-uniform: its rows see no key here

    // S = Q K^T for 16 rows x 64 keys: 8 n-tiles of 8 keys
    float s[kTileK / 8][4];
#pragma unroll
    for (int j = 0; j < kTileK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        const __nv_bfloat16* kr = &ks[8 * j + g][16 * c + 2 * t];
        mma_bf16(s[j], qa[c], ld_u32(kr), ld_u32(kr + 8));
      }
    }
    // scale, mask (ragged tail, causal, K2 length), running max over the quad
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int j = 0; j < kTileK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = kv0 + 8 * j + 2 * t + e;
        s[j][e] = key < n_lo ? s[j][e] * scale : -INFINITY;
        s[j][2 + e] = key < n_hi ? s[j][2 + e] * scale : -INFINITY;
        mx_lo = fmaxf(mx_lo, s[j][e]);
        mx_hi = fmaxf(mx_hi, s[j][2 + e]);
      }
    }
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    // a row that has seen no key keeps max -inf: exponentiate against 0 so
    // its probabilities are exp(-inf) = 0 rather than NaN
    const float ref_lo = mx_lo == -INFINITY ? 0.f : mx_lo;
    const float ref_hi = mx_hi == -INFINITY ? 0.f : mx_hi;
    const float alpha_lo = expf(m_lo - ref_lo), alpha_hi = expf(m_hi - ref_hi);
    m_lo = mx_lo;
    m_hi = mx_hi;
    l_lo *= alpha_lo;
    l_hi *= alpha_hi;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      acc[nb][0] *= alpha_lo;
      acc[nb][1] *= alpha_lo;
      acc[nb][2] *= alpha_hi;
      acc[nb][3] *= alpha_hi;
    }
    // O += P V, P repacked from the S accumulators (16 keys per k-step)
#pragma unroll
    for (int c = 0; c < kTileK / 16; ++c) {
      float p[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        p[h][0] = expf(s[2 * c + h][0] - ref_lo);
        p[h][1] = expf(s[2 * c + h][1] - ref_lo);
        p[h][2] = expf(s[2 * c + h][2] - ref_hi);
        p[h][3] = expf(s[2 * c + h][3] - ref_hi);
        l_lo += p[h][0] + p[h][1];
        l_hi += p[h][2] + p[h][3];
      }
      const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                              pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb) {
        const __nv_bfloat16* vr = &vt[8 * nb + g][16 * c + 2 * t];
        mma_bf16(acc[nb], pa, ld_u32(vr), ld_u32(vr + 8));
      }
    }
  }

  // denominators: each thread holds a quarter of its two rows' sums
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  // a row that saw no key has l == 0 and writes zeros
  const float inv_lo = l_lo > 0.f ? 1.f / l_lo : 0.f;
  const float inv_hi = l_hi > 0.f ? 1.f / l_hi : 0.f;
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) {
    const int col = 8 * nb + 2 * t;
    if (r_lo < Tq) {
      *reinterpret_cast<uint32_t*>(op + (size_t)r_lo * D + col) =
          pack_bf16(acc[nb][0] * inv_lo, acc[nb][1] * inv_lo);
    }
    if (r_hi < Tq) {
      *reinterpret_cast<uint32_t*>(op + (size_t)r_hi * D + col) =
          pack_bf16(acc[nb][2] * inv_hi, acc[nb][3] * inv_hi);
    }
  }
}

// ── f32: scalar FMAs ────────────────────────────────────────────────────

constexpr int kTileKf = 32;  // keys per shared-memory tile

template <int D, bool kVarlen>
__global__ void __launch_bounds__(kBlockQ)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              const int* __restrict__ kv_len, int H, int Tq, int Tk, float scale,
              int causal) {
  __shared__ __align__(16) float ks[kTileKf][D];
  __shared__ __align__(16) float vs[kTileKf][D];

  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const float* qp = q + bh * (size_t)Tq * D;
  const float* kp = k + bh * (size_t)Tk * D;
  const float* vp = v + bh * (size_t)Tk * D;
  float* op = o + bh * (size_t)Tq * D;

  const int row0 = blockIdx.x * kBlockQ;
  const int row = row0 + threadIdx.x;
  const int offs = Tk - Tq;
  const int len = example_keys<kVarlen>(kv_len, Tk);
  const int kv_end = row_keys<kVarlen>(min(row0 + kBlockQ, Tq) - 1, Tk, len, offs, causal);
  const int n_row = row < Tq ? row_keys<kVarlen>(row, Tk, len, offs, causal) : 0;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    qr[c] = row < Tq ? qp[(size_t)row * D + c] : 0.f;
    acc[c] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  for (int kv0 = 0; kv0 < kv_end; kv0 += kTileKf) {
    const int nt = min(kTileKf, len - kv0);
    __syncthreads();  // the previous tile is fully consumed
    for (int i = threadIdx.x; i < nt * D; i += kBlockQ) {
      ks[i / D][i % D] = kp[(size_t)kv0 * D + i];
      vs[i / D][i % D] = vp[(size_t)kv0 * D + i];
    }
    __syncthreads();
    const int jn = min(nt, n_row - kv0);  // keys of this tile the row sees
    if (jn <= 0) continue;

    float s[kTileKf];
    float m_new = m;
#pragma unroll
    for (int j = 0; j < kTileKf; ++j) {
      float dot = 0.f;
      if (j < jn) {
        const float4* kr = reinterpret_cast<const float4*>(ks[j]);
#pragma unroll
        for (int c = 0; c < D / 4; ++c) {
          const float4 kk = kr[c];
          dot = fmaf(qr[4 * c + 0], kk.x, dot);
          dot = fmaf(qr[4 * c + 1], kk.y, dot);
          dot = fmaf(qr[4 * c + 2], kk.z, dot);
          dot = fmaf(qr[4 * c + 3], kk.w, dot);
        }
        dot *= scale;
        m_new = fmaxf(m_new, dot);
      }
      s[j] = dot;
    }
    // jn > 0, so m_new is finite; on the first live tile m = -inf -> 0
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < kTileKf; ++j) {
      if (j < jn) {
        const float p = expf(s[j] - m_new);
        l += p;
        const float4* vr = reinterpret_cast<const float4*>(vs[j]);
#pragma unroll
        for (int c = 0; c < D / 4; ++c) {
          const float4 vv = vr[c];
          acc[4 * c + 0] = fmaf(p, vv.x, acc[4 * c + 0]);
          acc[4 * c + 1] = fmaf(p, vv.y, acc[4 * c + 1]);
          acc[4 * c + 2] = fmaf(p, vv.z, acc[4 * c + 2]);
          acc[4 * c + 3] = fmaf(p, vv.w, acc[4 * c + 3]);
        }
      }
    }
    m = m_new;
  }

  if (row < Tq) {
    // a row that saw no key has l == 0 and writes zeros
#pragma unroll
    for (int c = 0; c < D; ++c) op[(size_t)row * D + c] = l > 0.f ? acc[c] / l : 0.f;
  }
}

template <int D, bool kVarlen>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, void* o,
                   const int* kv_len, int B, int H, int Tq, int Tk, float scale,
                   int causal, cudaStream_t stream) {
  const dim3 grid((Tq + kBlockQ - 1) / kBlockQ, H, B);
  if (dtype == 1) {
    flash_fwd_bf16<D, kVarlen><<<grid, kWarps * 32, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        kv_len, H, Tq, Tk, scale, causal);
  } else {
    flash_fwd_f32<D, kVarlen><<<grid, kBlockQ, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), kv_len, H, Tq, Tk,
        scale, causal);
  }
  return cudaGetLastError();
}

template <bool kVarlen>
int dispatch(const void* q, const void* k, const void* v, void* o, const int* kv_len,
             int B, int H, int Tq, int Tk, int D, int dtype, float scale, int causal,
             void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tk < 0 || B > 65535 || H > 65535 ||
      (dtype != 0 && dtype != 1) || (kVarlen && kv_len == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) {
    return (int)launch<64, kVarlen>(dtype, q, k, v, o, kv_len, B, H, Tq, Tk, scale, causal, s);
  }
  if (D == 32) {
    return (int)launch<32, kVarlen>(dtype, q, k, v, o, kv_len, B, H, Tq, Tk, scale, causal, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K1. dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int os_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int Tq, int Tk, int D, int dtype,
                                      float scale, int causal, void* stream) {
  return dispatch<false>(q, k, v, o, nullptr, B, H, Tq, Tk, D, dtype, scale, causal, stream);
}

// K2: K1 with kv_len, B int32 valid kv lengths in device memory (clamped to
// [0, Tk]). Returns a cudaError_t (0 = launched).
extern "C" int os_flash_attention_varlen_fwd(const void* q, const void* k,
                                             const void* v, void* o,
                                             const int* kv_len, int B, int H,
                                             int Tq, int Tk, int D, int dtype,
                                             float scale, int causal,
                                             void* stream) {
  return dispatch<true>(q, k, v, o, kv_len, B, H, Tq, Tk, D, dtype, scale, causal, stream);
}
