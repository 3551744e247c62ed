// Flash attention forward for Hopper (sm_90a): tiled online-softmax MHA.
//
// Replaces the Pallas TPU kernels of `open_speech_tpu/ops/attention.py`
// (body `_flash_kernel`, plumbing `_flash_call`):
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
// What bounds each call on an H100 (989 TFLOP/s bf16, 3.35 TB/s):
//   - K1 at the whisper encoder [1,20,1500,1500,64] bf16 does
//     4*B*H*Tq*Tk*D = 11.5 GFLOP against 15.4 MB of q/k/v/o: 0.0116 ms of
//     tensor-core work vs 0.0046 ms of bytes, so operations bound it.
//   - K2 at the streaming block [1,20,128,1500,64] at length 1500 reads
//     2*L*D*H*2 = 7.7 MB of k/v for 1.0 us of operations: 0.0025 ms of
//     bytes, so bytes bound it, and only a grid that spans every SM can
//     pull the card's bandwidth.
//
// bf16 (the served path), `flash_fwd_bf16<D, kVarlen>`: one kernel for K1
// and K2, built from Hopper's asynchronous units.
//   - A block is one consumer warpgroup, owning 64 query rows, and one
//     producer warp; two blocks share an SM (blocks of two consumer
//     warpgroups over 128 rows measured slower, PERF.md). The producer
//     issues TMA loads (cp.async.bulk.tensor, 3-D maps over (D, T, B*H), so
//     a tile that runs past T is zero-filled inside its head): Q once, then K
//     and V tiles of 128 keys into a ring of kStages stages with a full and
//     an empty mbarrier per stage. Copies of later tiles overlap the
//     products on earlier ones.
//   - S = Q K^T is wgmma m64n128k16 with both operands in 128B- (D = 64) or
//     64B-swizzled (D = 32) shared memory, as TMA wrote them.
//   - The softmax runs in the accumulator registers in base 2 with f32
//     running max and sum: the max on the raw scores, then each p is one
//     FFMA (scale*log2 e folded in; the kernel takes scale > 0) and one ex2.
//     Only the tiles that need a mask pay for it: the ragged last tile, the
//     causal diagonal, K2's length tile. A row with no visible key
//     exponentiates against 0 and writes zeros (l = 0).
//   - O += P V is wgmma with P as the register A operand: the accumulator
//     fragment of S, repacked to bf16, is the A fragment of the next product,
//     so P never touches shared memory. V is the B operand as stored
//     ([keys][D], MN-major, the transpose flag set): no transpose pass.
//   - Tile j issues S_j, then P_{j-1} V_{j-1}, and runs its softmax while the
//     second product is on the tensor cores. The first and last tiles are
//     peeled so no wgmma group stays in flight across a branch (ptxas
//     otherwise serializes every wgmma of the kernel, C7520).
//   - K2 splits the kv axis: the grid is (q blocks, H, B*S) and split s owns
//     whole tiles [s*T_s, (s+1)*T_s) of 128 keys, clipped in-kernel to its
//     example's length (read from device memory; the host never sees it). A
//     split past the length loads nothing. With S > 1 each block writes its
//     unnormalised O, running max m and sum l (f32) to a workspace and
//     `flash_combine` merges the S partials of each row in a fixed order
//     (log-sum-exp weights), so the result is deterministic. In the tile that
//     holds the length, V rows at or past it are zeroed in shared memory
//     before P V: p = 0 would not cancel a NaN there (0 * NaN). At the
//     streaming block S = 4: 2 x 20 x 4 = 160 blocks.
//   - K1 runs without splits: at the encoder shape its 24 x 20 = 480 blocks
//     fill the 132 SMs, two at a time, in 1.82 waves.

// f32: `flash_fwd_f32`, scalar FMAs so the result stays f32-exact (tensor
// cores would round inputs to TF32). One thread owns one query row, with q
// and the accumulator in registers; K/V tiles of 32 keys are read from
// shared memory as float4 broadcasts. Grid (ceil(Tq/64), H, B), the kv loop
// cut at the causal bound and the length, no splits.

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is looked up at run time
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

// keys that exist for example b: Tk, or its valid prefix (K2)
template <bool kVarlen>
__device__ __forceinline__ int example_keys(const int* kv_len, int b, int Tk) {
  return kVarlen ? min(max(kv_len[b], 0), Tk) : Tk;
}

// ── bf16: wgmma + TMA ───────────────────────────────────────────────────

constexpr int kBlockN = 128;  // keys per kv tile
constexpr int kStages = 2;    // kv tiles in flight
constexpr int kThreads = 160;  // one consumer warpgroup (64 rows), one producer warp

template <int D>
struct SmemBf16 {  // every tile starts on a 1024-byte boundary (the swizzle's period)
  __nv_bfloat16 q[kBlockQ * D];
  __nv_bfloat16 k[kStages][kBlockN * D];
  __nv_bfloat16 v[kStages][kBlockN * D];
  uint64_t full[kStages];   // the tile has landed (TMA transaction bytes)
  uint64_t empty[kStages];  // every consumer warp is done with the tile
  uint64_t q_full;
};

struct FwdArgs {
  void* o;            // [B,H,Tq,D] bf16, or with splits > 1 the f32 partial O [B*S,H,Tq,D]
  float* m_part;      // [B*S,H,Tq] running max (log2 units), splits > 1 only
  float* l_part;      // [B*S,H,Tq] softmax denominator, splits > 1 only
  const int* kv_len;  // [B] (K2)
  int H, Tq, Tk, causal, splits, split_tiles;
  float scale_log2;   // scale * log2(e)
};

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

// one box of the 3-D map at (0, row, slice), completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int row,
                                         int slice) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0), "r"(row), "r"(slice)
      : "memory");
}

// wgmma shared-memory matrix descriptor for a tile of D*2-byte rows written
// by TMA: start address, leading and stride byte offsets (16-byte units),
// swizzle 128B (D = 64) or 64B (D = 32). The stride offset is one 8-row
// group (16*D bytes); the leading offset is unused by these layouts.
template <int D>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  constexpr uint64_t kSwizzle = D == 64 ? 1 : 2;
  constexpr uint64_t kLeading = 1, kStride = 16 * D / 16;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | kLeading << 16 | kStride << 32 |
         kSwizzle << 62;
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

// D[64 x 32] += A[64 x 16] B[16 x 32]: A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 64) {
    wgmma_rs_n64(o, a, b);
  } else {
    wgmma_rs_n32(o, a, b);
  }
}

// O += P V over one kv tile: P as register A fragments (16 keys per k-step),
// V the tile as stored, 16 rows (D*32 bytes) per k-step
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pa)[kBlockN / 16][4],
                                         uint32_t v_addr) {
#pragma unroll
  for (int c = 0; c < kBlockN / 16; ++c) wgmma_pv<D>(o, pa[c], smem_desc<D>(v_addr + c * 32 * D));
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

template <int D, bool kVarlen>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_bf16(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map, const FwdArgs args) {
  using Smem = SmemBf16<D>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                      ~static_cast<uintptr_t>(1023));

  const int Tq = args.Tq, Tk = args.Tk, causal = args.causal;
  const int b = blockIdx.z / args.splits, split = blockIdx.z % args.splits;
  const int slice = b * args.H + blockIdx.y;  // (example, head): the maps' third coordinate
  const int row0 = blockIdx.x * kBlockQ;
  const int offs = Tk - Tq;
  const int len = example_keys<kVarlen>(args.kv_len, b, Tk);
  // this split's keys, then those the block's last row sees
  const int kv_begin = split * args.split_tiles * kBlockN;
  const int kv_stop = min(kv_begin + args.split_tiles * kBlockN, Tk);
  const int kv_end =
      min(kv_stop, row_keys<kVarlen>(min(row0 + kBlockQ, Tq) - 1, Tk, len, offs, causal));
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
    if (lane == 0 && kv_begin < kv_end) {
      mbar_expect_tx(&sm.q_full, kBlockQ * D * 2);
      tma_load(sm.q, &q_map, &sm.q_full, row0, slice);
      int stage = 0;
      uint32_t phase = 0;
      for (int kv0 = kv_begin; kv0 < kv_end; kv0 += kBlockN) {
        mbar_wait(&sm.empty[stage], phase ^ 1);  // the first round passes at once
        mbar_expect_tx(&sm.full[stage], 2 * kBlockN * D * 2);
        tma_load(sm.k[stage], &k_map, &sm.full[stage], kv0, slice);
        tma_load(sm.v[stage], &v_map, &sm.full[stage], kv0, slice);
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
  const int n_lo = row_keys<kVarlen>(min(r_lo, Tq - 1), Tk, len, offs, causal);
  const int n_hi = row_keys<kVarlen>(min(r_hi, Tq - 1), Tk, len, offs, causal);
  // tiles that end at or below the block's first row's keys need no mask
  const int all_see = row_keys<kVarlen>(row0, Tk, len, offs, causal);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

  // Tile j issues S_j = Q K_j^T and then O += P_{j-1} V_{j-1}, and runs its
  // softmax while the second product is on the tensor cores; O is rescaled
  // once that product is done. The first and last tiles are peeled, so every
  // wgmma group is issued and drained without a branch in between.
  if (kv_begin < kv_end) {
    mbar_wait(&sm.q_full, 0);
    const uint32_t q_addr = smem_u32(sm.q);
    const int n_tiles = (kv_end - kv_begin + kBlockN - 1) / kBlockN;
    int stage = 0, prev = 0;  // tile j's stage; tile j-1's, whose P V is pending
    uint32_t phase = 0;
    uint32_t pa[kBlockN / 16][4];  // P_{j-1}: the A fragments of its P V
    float s[kBlockN / 2];
    // wait for tile j; K2's length tile: zero V rows [len, kv0 + 128) (whole
    // rows, so the swizzle does not matter) and make the stores visible to
    // wgmma
    auto wait_tile = [&](int kv0) {
      mbar_wait(&sm.full[stage], phase);
      if (kVarlen && kv0 < len && len < min(kv0 + kBlockN, Tk)) {
        uint4* vz = reinterpret_cast<uint4*>(sm.v[stage] + (len - kv0) * D);
        for (int i = threadIdx.x; i < (kv0 + kBlockN - len) * D / 8; i += 128) {
          vz[i] = make_uint4(0, 0, 0, 0);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync 1, 128;\n" ::: "memory");  // the consumer warps
      }
    };
    auto next_stage = [&] {
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    };
    auto issue_s = [&] {
      const uint32_t k_addr = smem_u32(sm.k[stage]);
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {  // 64 rows x 128 keys, D/16 k-steps of 32 bytes
        wgmma_ss_n128(s, smem_desc<D>(q_addr + 32 * c), smem_desc<D>(k_addr + 32 * c), c);
      }
      wgmma_commit();
    };
    // S (done) -> P in place; returns each row's rescale of O and l. Masks
    // (ragged tail, causal, K2 length) only where a row of the block stops
    // inside the tile. Fragment element i: key kv0 + 8*(i/4) + 2t +
    // i%2, row r_lo (i%4 < 2) or r_hi. The running max m is in log2 units;
    // with scale > 0 the raw max scales to it, and each p is one FFMA and
    // one ex2.
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
      for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? alpha_hi : alpha_lo;
#pragma unroll
      for (int c = 0; c < kBlockN / 16; ++c) {
        pa[c][0] = pack_bf16(s[8 * c + 0], s[8 * c + 1]);
        pa[c][1] = pack_bf16(s[8 * c + 2], s[8 * c + 3]);
        pa[c][2] = pack_bf16(s[8 * c + 4], s[8 * c + 5]);
        pa[c][3] = pack_bf16(s[8 * c + 6], s[8 * c + 7]);
      }
    };

    float alpha_lo, alpha_hi;
    wait_tile(kv_begin);
    wgmma_fence();
    issue_s();
    wgmma_wait<0>();
    pin(s);
    softmax(kv_begin, alpha_lo, alpha_hi);
    rescale_and_pack(alpha_lo, alpha_hi);
    next_stage();
    for (int j = 1; j < n_tiles; ++j) {
      const int kv0 = kv_begin + j * kBlockN;
      wait_tile(kv0);
      wgmma_fence();
      issue_s();
      issue_pv<D>(o, pa, smem_u32(sm.v[prev]));
      wgmma_commit();
      wgmma_wait<1>();  // S_j is done; P_{j-1} V_{j-1} may still run
      pin(s);
      softmax(kv0, alpha_lo, alpha_hi);
      wgmma_wait<0>();  // O and P_{j-1}'s registers are free
      pin(o);
      release(&sm.empty[prev], lane);
      rescale_and_pack(alpha_lo, alpha_hi);
      next_stage();
    }
    wgmma_fence();
    issue_pv<D>(o, pa, smem_u32(sm.v[prev]));
    wgmma_commit();
    wgmma_wait<0>();
    pin(o);
    release(&sm.empty[prev], lane);
  }

  // denominators: each thread holds a quarter of its two rows' sums
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  if (args.splits == 1) {
    // a row that saw no key has l == 0 and writes zeros
    const float inv_lo = l_lo > 0.f ? 1.f / l_lo : 0.f;
    const float inv_hi = l_hi > 0.f ? 1.f / l_hi : 0.f;
    __nv_bfloat16* op = static_cast<__nv_bfloat16*>(args.o) + (size_t)slice * Tq * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (r_lo < Tq) {
        *reinterpret_cast<uint32_t*>(op + (size_t)r_lo * D + col) =
            pack_bf16(o[4 * j] * inv_lo, o[4 * j + 1] * inv_lo);
      }
      if (r_hi < Tq) {
        *reinterpret_cast<uint32_t*>(op + (size_t)r_hi * D + col) =
            pack_bf16(o[4 * j + 2] * inv_hi, o[4 * j + 3] * inv_hi);
      }
    }
  } else {
    // this split's partial (a split that saw no key: O = 0, m = -inf, l = 0)
    const size_t part = (size_t)blockIdx.z * args.H + blockIdx.y;  // (b * S + split, h)
    float* op = static_cast<float*>(args.o) + part * Tq * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (r_lo < Tq) {
        *reinterpret_cast<float2*>(op + (size_t)r_lo * D + col) = make_float2(o[4 * j], o[4 * j + 1]);
      }
      if (r_hi < Tq) {
        *reinterpret_cast<float2*>(op + (size_t)r_hi * D + col) =
            make_float2(o[4 * j + 2], o[4 * j + 3]);
      }
    }
    if (t == 0) {
      if (r_lo < Tq) {
        args.m_part[part * Tq + r_lo] = m_lo;
        args.l_part[part * Tq + r_lo] = l_lo;
      }
      if (r_hi < Tq) {
        args.m_part[part * Tq + r_hi] = m_hi;
        args.l_part[part * Tq + r_hi] = l_hi;
      }
    }
  }
}

// Merges K2's kv-split partials: out[b,h,r] = sum_s w_s O_s / sum_s w_s l_s
// with w_s = 2^(m_s - max_s m_s), in split order (deterministic); zeros
// where every l_s is 0. One thread per 4 output columns.
template <int D>
__global__ void __launch_bounds__(256)
flash_combine(const float* __restrict__ o_part, const float* __restrict__ m_part,
              const float* __restrict__ l_part, __nv_bfloat16* __restrict__ o, int S, int HT,
              int rows) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = i / (D / 4), c = i % (D / 4);
  if (row >= rows) return;
  const size_t base = (size_t)(row / HT) * S * HT + row % HT;  // split s at base + s * HT
  float mx = -INFINITY;
  for (int s = 0; s < S; ++s) mx = fmaxf(mx, m_part[base + (size_t)s * HT]);
  const float ref = mx == -INFINITY ? 0.f : mx;
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < S; ++s) {
    const size_t p = base + (size_t)s * HT;
    const float w = exp2_approx(m_part[p] - ref);
    if (w == 0.f) continue;  // a split that saw no key of this row
    l += w * l_part[p];
    const float4 x = reinterpret_cast<const float4*>(o_part + p * D)[c];
    acc.x += w * x.x;
    acc.y += w * x.y;
    acc.z += w * x.z;
    acc.w += w * x.w;
  }
  const float inv = l > 0.f ? 1.f / l : 0.f;
  *reinterpret_cast<uint2*>(o + (size_t)row * D + 4 * c) =
      make_uint2(pack_bf16(acc.x * inv, acc.y * inv), pack_bf16(acc.z * inv, acc.w * inv));
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
  const int len = example_keys<kVarlen>(kv_len, blockIdx.z, Tk);
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

// a [slices, T, D] bf16 tensor in boxes of rows x D, swizzled for wgmma;
// rows past T read as zeros
bool encode_map(CUtensorMap* map, const void* base, int D, int T, int slices, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)slices};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)T * D * 2};  // bytes
  const cuuint32_t box[3] = {(cuuint32_t)D, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            D == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool kVarlen>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const FwdArgs& a, int B,
                        cudaStream_t stream) {
  CUtensorMap maps[3];
  const int slices = B * a.H;
  // Tk == 0: no tile is loaded; the maps only need to be valid
  const void* kb = a.Tk > 0 ? k : q;
  const void* vb = a.Tk > 0 ? v : q;
  const int tk = a.Tk > 0 ? a.Tk : a.Tq;
  if (!encode_map(&maps[0], q, D, a.Tq, slices, kBlockQ) ||
      !encode_map(&maps[1], kb, D, tk, slices, kBlockN) ||
      !encode_map(&maps[2], vb, D, tk, slices, kBlockN)) {
    return cudaErrorInvalidValue;
  }
  const auto kernel = flash_fwd_bf16<D, kVarlen>;
  constexpr int smem = sizeof(SmemBf16<D>) + 1024;  // + the 1024-byte alignment
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.Tq + kBlockQ - 1) / kBlockQ, a.H, B * a.splits);
  kernel<<<grid, kThreads, smem, stream>>>(maps[0], maps[1], maps[2], a);
  return cudaGetLastError();
}

template <int D, bool kVarlen>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, const FwdArgs& a,
                   int B, float scale, cudaStream_t stream) {
  if (dtype == 1) return launch_bf16<D, kVarlen>(q, k, v, a, B, stream);
  const dim3 grid((a.Tq + kBlockQ - 1) / kBlockQ, a.H, B);
  flash_fwd_f32<D, kVarlen><<<grid, kBlockQ, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(a.o), a.kv_len, a.H, a.Tq, a.Tk, scale, a.causal);
  return cudaGetLastError();
}

template <bool kVarlen>
int dispatch(const void* q, const void* k, const void* v, void* o, const int* kv_len,
             float* m_part, float* l_part, int splits, int split_tiles, int B, int H, int Tq,
             int Tk, int D, int dtype, float scale, int causal, void* stream) {
  const long tiles = (Tk + kBlockN - 1) / kBlockN;
  if (B < 1 || H < 1 || Tq < 1 || Tk < 0 || H > 65535 || (dtype != 0 && dtype != 1) ||
      (kVarlen && kv_len == nullptr) || splits < 1 || split_tiles < 1 ||
      (long)B * splits > 65535 || (long)splits * split_tiles < tiles ||
      (splits > 1 && (dtype != 1 || m_part == nullptr || l_part == nullptr)) ||
      (dtype == 1 && !(scale > 0.f))) {
    return (int)cudaErrorInvalidValue;
  }
  const FwdArgs a{o, m_part, l_part, kv_len, H, Tq, Tk, causal, splits, split_tiles,
                  scale * 1.4426950408889634f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return (int)launch<64, kVarlen>(dtype, q, k, v, a, B, scale, s);
  if (D == 32) return (int)launch<32, kVarlen>(dtype, q, k, v, a, B, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K1. dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int os_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int Tq, int Tk, int D, int dtype,
                                      float scale, int causal, void* stream) {
  const int tiles = Tk > kBlockN ? (Tk + kBlockN - 1) / kBlockN : 1;
  return dispatch<false>(q, k, v, o, nullptr, nullptr, nullptr, 1, tiles, B, H, Tq, Tk, D, dtype,
                         scale, causal, stream);
}

// K2: K1 with kv_len, B int32 valid kv lengths in device memory (clamped to
// [0, Tk]), over `splits` ranges of `split_tiles` tiles of 128 keys. With
// splits > 1 (bf16 only) `o` is the f32 partial O [B,S,H,Tq,D] and m_part,
// l_part [B,S,H,Tq] take each row's max and sum; os_flash_combine merges
// them. Returns a cudaError_t (0 = launched).
extern "C" int os_flash_attention_varlen_fwd(const void* q, const void* k,
                                             const void* v, void* o,
                                             const int* kv_len, float* m_part,
                                             float* l_part, int splits,
                                             int split_tiles, int B, int H,
                                             int Tq, int Tk, int D, int dtype,
                                             float scale, int causal,
                                             void* stream) {
  return dispatch<true>(q, k, v, o, kv_len, m_part, l_part, splits, split_tiles, B, H, Tq, Tk, D,
                        dtype, scale, causal, stream);
}

// Dynamic shared memory of a bf16 block (Q, the K/V ring, the barriers and
// the 1024-byte alignment), or -1 for a head dim that has no kernel.
extern "C" int os_flash_attention_smem_bytes(int D) {
  return D == 64 ? (int)sizeof(SmemBf16<64>) + 1024 : D == 32 ? (int)sizeof(SmemBf16<32>) + 1024 : -1;
}

// K2's second pass: o [B,H,Tq,D] bf16 from the S partials of
// os_flash_attention_varlen_fwd. Returns a cudaError_t (0 = launched).
extern "C" int os_flash_combine(const float* o_part, const float* m_part,
                                const float* l_part, void* o, int B, int S,
                                int H, int Tq, int D, void* stream) {
  if (B < 1 || S < 1 || H < 1 || Tq < 1 || (D != 32 && D != 64) ||
      (long)B * H * Tq * D / 4 > 0x7fffffffL) {
    return (int)cudaErrorInvalidValue;
  }
  const int rows = B * H * Tq;
  const int threads = 256, blocks = (rows * (D / 4) + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(o);
  if (D == 64) {
    flash_combine<64><<<blocks, threads, 0, s>>>(o_part, m_part, l_part, out, S, H * Tq, rows);
  } else {
    flash_combine<32><<<blocks, threads, 0, s>>>(o_part, m_part, l_part, out, S, H * Tq, rows);
  }
  return (int)cudaGetLastError();
}
