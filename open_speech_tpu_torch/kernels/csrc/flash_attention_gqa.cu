// K1 at head dim 128 with grouped KV heads, for Hopper (sm_90a): the causal
// prefill of a decoder-only language model (Voxtral's, GQA 4:1).
//
// Replaces no TPU kernel of its own: it is K1 (`open_speech_tpu/ops/
// attention.py` `_flash_attention_tpu`, kv_length None) at a head dim and a
// head layout the JAX package never runs. q [B,H,Tq,128], k/v
// [B,H_kv,Tk,128], bf16, contiguous, H a multiple of H_kv: query head h
// reads KV head h / (H / H_kv), taken in the TMA coordinates, so K and V are
// never repeated. logits = (q . k) * scale; optional end-aligned causal mask
// (row i sees keys j <= i + Tk - Tq); a row with no visible key gives
// zeros; output bf16 [B,H,Tq,128].
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s): at the prefill of
// 8 windows [8, 32 / 8, 382, 382, 128] causal the visible pairs take 4 * B
// * H * 73,153 * 128 = 9.6 GFLOP, 0.0097 ms at the peak, against 2 x 25.0
// MB of q and o and 2 x 6.3 MB of K and V read once, 0.0187 ms: bytes
// bound it (the grouping reads a quarter of K and V's bytes).
//
// Design: `flash_fwd_bf16<D, false>` of flash_attention.cu (whose D = 32
// and 64 instantiations serve Whisper and stay as they are) at D = 128.
//   - A 128-wide bf16 row is 256 bytes, past the 128-byte swizzle's span, so
//     every tile is two column halves of 64, each a TMA box of rows x 64
//     with the 128-byte swizzle (the D = 64 layout), loaded at column 0
//     and 64 of one 3-D map over (128, T, slices).
//   - S = Q K^T is eight k-steps of wgmma m64n128k16, four in each half.
//   - O += P V is two m64n64 accumulators, one per half of V's columns,
//     each the D = 64 product with P as the register A operand.
//   - Q 16 KB, K and V tiles of 128 keys in two stages, 144 KB with the
//     barriers: one block (one consumer warpgroup over 64 rows and one
//     producer warp) an SM.
//   - The grouped head is the KV map's third coordinate: b * H_kv + h /
//     group. The group's query heads are neighbouring blocks of the grid, so
//     their K and V tiles come from L2 after the first read.

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 128;       // head dim
constexpr int kHalf = 64;    // columns of a half tile (128 bytes: the swizzle's span)
constexpr int kBlockQ = 64;  // query rows per block
constexpr int kBlockN = 128;  // keys per kv tile
constexpr int kStages = 2;    // kv tiles in flight
constexpr int kThreads = 160;  // one consumer warpgroup (64 rows), one producer warp

struct Smem {  // every half tile starts on a 1024-byte boundary (the swizzle's period)
  __nv_bfloat16 q[2][kBlockQ * kHalf];
  __nv_bfloat16 k[kStages][2][kBlockN * kHalf];
  __nv_bfloat16 v[kStages][2][kBlockN * kHalf];
  uint64_t full[kStages];   // the tile has landed (TMA transaction bytes)
  uint64_t empty[kStages];  // every consumer warp is done with the tile
  uint64_t q_full;
};

struct Args {
  __nv_bfloat16* o;  // [B,H,Tq,128]
  int H, group, Tq, Tk, causal;
  float scale_log2;  // scale * log2(e)
};

// keys visible to query row r: [0, visible)
__device__ __forceinline__ int visible_keys(int r, int tk, int offs, int causal) {
  return causal ? min(max(r + offs + 1, 0), tk) : tk;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// wait until the barrier's phase `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of the 3-D map at (col, row, slice), completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int col,
                                         int row, int slice) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row), "r"(slice)
      : "memory");
}

// both halves of a tile of `rows` rows at (row, slice)
__device__ __forceinline__ void tma_load_tile(__nv_bfloat16 (&dst)[2][kBlockN * kHalf],
                                              const CUtensorMap* map, uint64_t* bar, int row,
                                              int slice) {
  tma_load(dst[0], map, bar, 0, row, slice);
  tma_load(dst[1], map, bar, kHalf, row, slice);
}

// wgmma shared-memory matrix descriptor for a half tile of 128-byte rows
// written by TMA with the 128-byte swizzle: start address, leading and
// stride byte offsets (16-byte units). The stride offset is one 8-row group
// (1024 bytes); the leading offset is unused by this layout.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  constexpr uint64_t kSwizzle128 = 1, kLeading = 1, kStride = 1024 / 16;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | kLeading << 16 | kStride << 32 |
         kSwizzle128 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>  // wait until at most N committed groups are in flight
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across a wgmma
// issue or wait
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128]: A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]: A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O += P V over one kv tile: P as register A fragments (16 keys per k-step),
// each half of V's columns as stored, 16 rows (2048 bytes) per k-step
__device__ __forceinline__ void issue_pv(float (&o0)[32], float (&o1)[32],
                                         const uint32_t (&pa)[kBlockN / 16][4], uint32_t v0,
                                         uint32_t v1) {
#pragma unroll
  for (int c = 0; c < kBlockN / 16; ++c) {
    wgmma_rs_n64(o0, pa[c], smem_desc(v0 + c * 32 * kHalf));
    wgmma_rs_n64(o1, pa[c], smem_desc(v1 + c * 32 * kHalf));
  }
}

// a consumer warp is done with a stage
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float exp2_approx(float x) {  // ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_gqa_bf16(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map, const Args args) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                      ~static_cast<uintptr_t>(1023));

  const int Tq = args.Tq, Tk = args.Tk, causal = args.causal;
  const int b = blockIdx.z, h = blockIdx.y;
  const int slice = b * args.H + h;  // (example, query head): Q's and O's third coordinate
  const int kv_slice = b * (args.H / args.group) + h / args.group;  // its KV head
  const int row0 = blockIdx.x * kBlockQ;
  const int offs = Tk - Tq;
  // the keys the block's last row sees
  const int kv_end = visible_keys(min(row0 + kBlockQ, Tq) - 1, Tk, offs, causal);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 4);
    }
    mbar_init(&sm.q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {  // the producer warp: one thread issues every copy
    if (lane == 0 && kv_end > 0) {
      mbar_expect_tx(&sm.q_full, kBlockQ * D * 2);
      tma_load(sm.q[0], &q_map, &sm.q_full, 0, row0, slice);
      tma_load(sm.q[1], &q_map, &sm.q_full, kHalf, row0, slice);
      int stage = 0;
      uint32_t phase = 0;
      for (int kv0 = 0; kv0 < kv_end; kv0 += kBlockN) {
        mbar_wait(&sm.empty[stage], phase ^ 1);  // the first round passes at once
        mbar_expect_tx(&sm.full[stage], 2 * kBlockN * D * 2);
        tma_load_tile(sm.k[stage], &k_map, &sm.full[stage], kv0, kv_slice);
        tma_load_tile(sm.v[stage], &v_map, &sm.full[stage], kv0, kv_slice);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // the consumer warpgroup (warps 0-3): this thread holds rows r_lo and r_hi
  // of the accumulator fragments (g = lane / 4)
  const int g = lane / 4, t = lane % 4;
  const int r_lo = row0 + warp * 16 + g, r_hi = r_lo + 8;
  // rows past Tq are computed on Q's zero fill and never stored
  const int n_lo = visible_keys(min(r_lo, Tq - 1), Tk, offs, causal);
  const int n_hi = visible_keys(min(r_hi, Tq - 1), Tk, offs, causal);
  // tiles that end at or below the block's first row's keys need no mask
  const int all_see = visible_keys(row0, Tk, offs, causal);

  // O's columns 0-63 (o0) and 64-127 (o1), each an m64n64 accumulator
  float o0[32], o1[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o0[i] = o1[i] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

  // Tile j issues S_j = Q K_j^T and then O += P_{j-1} V_{j-1}, and runs its
  // softmax while the second product is on the tensor cores; O is rescaled
  // once that product is done. The first and last tiles are peeled, so every
  // wgmma group is issued and drained without a branch in between.
  if (kv_end > 0) {
    mbar_wait(&sm.q_full, 0);
    const uint32_t q0 = smem_u32(sm.q[0]), q1 = smem_u32(sm.q[1]);
    const int n_tiles = (kv_end + kBlockN - 1) / kBlockN;
    int stage = 0, prev = 0;  // tile j's stage; tile j-1's, whose P V is pending
    uint32_t phase = 0;
    uint32_t pa[kBlockN / 16][4];  // P_{j-1}: the A fragments of its P V
    float s[kBlockN / 2];
    auto next_stage = [&] {
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    };
    auto issue_s = [&] {
      const uint32_t k0 = smem_u32(sm.k[stage][0]), k1 = smem_u32(sm.k[stage][1]);
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {  // 64 rows x 128 keys, 8 k-steps of 32 bytes, 4 a half
        const uint32_t off = 32 * (c % 4);
        wgmma_ss_n128(s, smem_desc((c < 4 ? q0 : q1) + off), smem_desc((c < 4 ? k0 : k1) + off), c);
      }
      wgmma_commit();
    };
    // S (done) -> P in place; returns each row's rescale of O and l. Masks
    // (ragged tail, causal) only where a row of the block stops inside the
    // tile. Fragment element i: key kv0 + 8*(i/4) + 2t + i%2, row r_lo
    // (i%4 < 2) or r_hi. The running max m is in log2 units; with scale >
    // 0 the raw max scales to it, and each p is one FFMA and one ex2.
    float sum_lo, sum_hi;
    auto softmax = [&](int kv0, float& alpha_lo, float& alpha_hi) {
      if (kv0 + kBlockN > all_see) {
#pragma unroll
        for (int i = 0; i < kBlockN / 2; ++i) {
          const int key = kv0 + 8 * (i / 4) + 2 * t + (i & 1);
          s[i] = key < ((i & 2) ? n_hi : n_lo) ? s[i] : -INFINITY;
        }
      }
      float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
      for (int i = 0; i < kBlockN / 2; ++i) {
        if (i & 2) {
          mx_hi = fmaxf(mx_hi, s[i]);
        } else {
          mx_lo = fmaxf(mx_lo, s[i]);
        }
      }
      // a row is spread over the 4 threads of a quad
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
      mx_lo = fmaxf(m_lo, mx_lo * args.scale_log2);
      mx_hi = fmaxf(m_hi, mx_hi * args.scale_log2);
      // a row that has seen no key keeps max -inf: exponentiate against 0
      // so its probabilities are 2^-inf = 0 rather than NaN
      const float ref_lo = mx_lo == -INFINITY ? 0.f : mx_lo;
      const float ref_hi = mx_hi == -INFINITY ? 0.f : mx_hi;
      alpha_lo = exp2_approx(m_lo - ref_lo);
      alpha_hi = exp2_approx(m_hi - ref_hi);
      m_lo = mx_lo;
      m_hi = mx_hi;
      sum_lo = sum_hi = 0.f;
#pragma unroll
      for (int i = 0; i < kBlockN / 2; ++i) {
        s[i] = exp2_approx(fmaf(s[i], args.scale_log2, (i & 2) ? -ref_hi : -ref_lo));
        if (i & 2) {
          sum_hi += s[i];
        } else {
          sum_lo += s[i];
        }
      }
    };
    // rescale O and l, then P_j as A fragments, 16 keys per k-step: the S
    // fragments of keys 16c.. and 16c+8.. are A's (row, k) halves
    auto rescale_and_pack = [&](float alpha_lo, float alpha_hi) {
      l_lo = l_lo * alpha_lo + sum_lo;
      l_hi = l_hi * alpha_hi + sum_hi;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        o0[i] *= (i & 2) ? alpha_hi : alpha_lo;
        o1[i] *= (i & 2) ? alpha_hi : alpha_lo;
      }
#pragma unroll
      for (int c = 0; c < kBlockN / 16; ++c) {
        pa[c][0] = pack_bf16(s[8 * c + 0], s[8 * c + 1]);
        pa[c][1] = pack_bf16(s[8 * c + 2], s[8 * c + 3]);
        pa[c][2] = pack_bf16(s[8 * c + 4], s[8 * c + 5]);
        pa[c][3] = pack_bf16(s[8 * c + 6], s[8 * c + 7]);
      }
    };

    float alpha_lo, alpha_hi;
    mbar_wait(&sm.full[stage], phase);
    wgmma_fence();
    issue_s();
    wgmma_wait<0>();
    pin(s);
    softmax(0, alpha_lo, alpha_hi);
    rescale_and_pack(alpha_lo, alpha_hi);
    next_stage();
    for (int j = 1; j < n_tiles; ++j) {
      const int kv0 = j * kBlockN;
      mbar_wait(&sm.full[stage], phase);
      wgmma_fence();
      issue_s();
      issue_pv(o0, o1, pa, smem_u32(sm.v[prev][0]), smem_u32(sm.v[prev][1]));
      wgmma_commit();
      wgmma_wait<1>();  // S_j is done; P_{j-1} V_{j-1} may still run
      pin(s);
      softmax(kv0, alpha_lo, alpha_hi);
      wgmma_wait<0>();  // O and P_{j-1}'s registers are free
      pin(o0);
      pin(o1);
      release(&sm.empty[prev], lane);
      rescale_and_pack(alpha_lo, alpha_hi);
      next_stage();
    }
    wgmma_fence();
    issue_pv(o0, o1, pa, smem_u32(sm.v[prev][0]), smem_u32(sm.v[prev][1]));
    wgmma_commit();
    wgmma_wait<0>();
    pin(o0);
    pin(o1);
    release(&sm.empty[prev], lane);
  }

  // denominators: each thread holds a quarter of its two rows' sums
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  // a row that saw no key has l == 0 and writes zeros
  const float inv_lo = l_lo > 0.f ? 1.f / l_lo : 0.f;
  const float inv_hi = l_hi > 0.f ? 1.f / l_hi : 0.f;
  __nv_bfloat16* op = args.o + (size_t)slice * Tq * D;
#pragma unroll
  for (int j = 0; j < kHalf / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (r_lo < Tq) {
      __nv_bfloat16* row = op + (size_t)r_lo * D + col;
      *reinterpret_cast<uint32_t*>(row) = pack_bf16(o0[4 * j] * inv_lo, o0[4 * j + 1] * inv_lo);
      *reinterpret_cast<uint32_t*>(row + kHalf) =
          pack_bf16(o1[4 * j] * inv_lo, o1[4 * j + 1] * inv_lo);
    }
    if (r_hi < Tq) {
      __nv_bfloat16* row = op + (size_t)r_hi * D + col;
      *reinterpret_cast<uint32_t*>(row) =
          pack_bf16(o0[4 * j + 2] * inv_hi, o0[4 * j + 3] * inv_hi);
      *reinterpret_cast<uint32_t*>(row + kHalf) =
          pack_bf16(o1[4 * j + 2] * inv_hi, o1[4 * j + 3] * inv_hi);
    }
  }
}

// ── host ────────────────────────────────────────────────────────────────

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's entry-point lookup, so the
// library does not link libcuda
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a [slices, T, 128] bf16 tensor in boxes of rows x 64 (a column half),
// swizzled for wgmma; rows past T read as zeros
bool encode_map(CUtensorMap* map, const void* base, int T, int slices, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)slices};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)T * D * 2};  // bytes
  const cuuint32_t box[3] = {(cuuint32_t)kHalf, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// K1 at D = 128 with grouped KV heads: q [B,H,Tq,128], k and v
// [B,H_kv,Tk,128], o [B,H,Tq,128], all bf16 and contiguous; H_kv divides
// H; scale > 0. Returns a cudaError_t (0 = launched).
extern "C" int os_flash_attention_gqa_fwd(const void* q, const void* k, const void* v, void* o,
                                          int B, int H, int H_kv, int Tq, int Tk, float scale,
                                          int causal, void* stream) {
  if (B < 1 || H < 1 || H_kv < 1 || H % H_kv || Tq < 1 || Tk < 1 || H > 65535 || B > 65535 ||
      !(scale > 0.f)) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap maps[3];
  if (!encode_map(&maps[0], q, Tq, B * H, kBlockQ) ||
      !encode_map(&maps[1], k, Tk, B * H_kv, kBlockN) ||
      !encode_map(&maps[2], v, Tk, B * H_kv, kBlockN)) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr int smem = sizeof(Smem) + 1024;  // + alignment
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_gqa_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const Args a{static_cast<__nv_bfloat16*>(o), H, H / H_kv, Tq, Tk, causal,
               scale * 1.4426950408889634f};
  const dim3 grid((Tq + kBlockQ - 1) / kBlockQ, H, B);
  flash_fwd_gqa_bf16<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(maps[0], maps[1],
                                                                                 maps[2], a);
  return (int)cudaGetLastError();
}
