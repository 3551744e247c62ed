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
// log-sum-exp: delta = sum_j P_j dP_j needs S and dP in a pass of its own
// whatever the forward writes, so a forward-side lse would save no
// product. Three kernels, one launch each, no atomics (the result does not
// depend on the order the blocks run in):
//   0 prep: one block per (b, h, 64 query rows), one pass over the row's
//     live kv tiles with an online max. lse2 = the row's log2-sum-exp2 of
//     scale * log2(e) * (q . k) over its visible keys (+inf for a row with
//     no key, so its probabilities come out 0), and delta = sum_j P_j dP_j
//     with dP = dO V^T, both in f32. That is rowsum(dO * O) with O in f32:
//     from the forward's bf16 O, delta's rounding would not cancel in
//     sum_j dS_j = 0, and dQ = dS K would carry it times the keys' common
//     component, which is large in a cross-attention over layer-normed
//     encoder states.
//   1 dkdv: one block per (b, h, 64 keys), looping over the query tiles
//     that see any of its keys. With P = exp2(S' - lse2):
//     dV += P^T dO, dP = dO V^T, dS = P * (dP - delta), dK += dS^T Q.
//   2 dq: one block per (b, h, 64 query rows), looping over its live kv
//     tiles: dQ += dS K.
//   dQ and dK take the softmax scale at the end. Causal tiles with no
//   visible pair are skipped in both loops.
//
// What bounds it on an H100 (989 TFLOP/s bf16 tensor cores, 67 TFLOP/s f32
// outside them, 3.35 TB/s): at the whisper encoder [1,20,1500,1500,64] the
// least work is 5 products of 2*B*H*Tq*Tk*D = 5.76 GFLOP each (28.8 GFLOP)
// against 26.9 MB of q, k, v, dO in and dq, dk, dv out: operations bound it
// (0.029 ms of tensor-core work vs 0.0080 ms of bytes in bf16).
//
// bf16 (`flash_bwd_{prep,dkdv,dq}_bf16<D>`), built as the forward is.
//   - A block is one consumer warpgroup over a fixed 64-row pair of tiles
//     and one producer warp; two blocks share an SM (three in prep). The
//     producer issues TMA loads (3-D maps over (D, T, B*H), rows past T
//     zero-filled inside the head): the fixed pair once (Q and dO in prep
//     and dq, K and V in dkdv), then the streamed pair (K and V, or Q and
//     dO) 64 rows at a time into a ring of kStages stages with a full and
//     an empty mbarrier per stage. In dkdv the producer's lanes also stage
//     the streamed rows' lse2 and delta (+inf and 0 past Tq) and arrive on
//     the full barrier.
//   - Every step's two score products have one form: fixed x streamed^T,
//     S = Q K^T and dP = dO V^T in prep and dq, S^T = K Q^T and
//     dP^T = V dO^T in dkdv (so dkdv's accumulators already have keys as
//     rows). Each is wgmma m64nNk16 with both operands K-major in 128B-
//     (D = 64) or 64B-swizzled (D = 32) shared memory, as TMA wrote them.
//   - The products that take P or dS, dV += P^T dO, dK += dS^T Q and
//     dQ += dS K, are wgmma with the register A operand: the f32
//     accumulator fragment of the scores is the A fragment of the next
//     product (as P is in the forward), and the streamed tile is the B
//     operand as stored (MN-major, the transpose bit, which bf16 has).
//   - Split operand. A plain bf16 P or dS (what FA2/FA3 feed their MMAs)
//     rounds each probability by up to 2^-9: 1.1e-3 to 3.3e-3 of max|ref|
//     on the gradients, above the bound this kernel is held to (half a bf16
//     ulp of the f32 gradient plus 1e-4 of max|ref|). So each of P and dS
//     goes in as two bf16 fragments, hi = rn(x) and lo = rn(x - hi), and
//     each such product runs twice, accumulating in f32: the operand is
//     then exact to about 2^-17 relative, and q, k, v and dO are exact in
//     bf16 already. 12 products of [64 x 64 x D] per tile pair in all
//     (prep 2, dkdv 2 + 2 x 2, dq 2 + 2) against the 5 of the bound.
//   - Each step issues its products, commits and waits before any branch
//     (a group in flight across a branch makes ptxas serialise every wgmma,
//     C7520); masks are applied after the wait, and only on the tiles that
//     need them: the ragged last kv tile and the causal diagonal in prep
//     and dq (dq masks the ragged tile too: past Tk the zero-filled K gives
//     P = 2^-lse2, which may overflow, times a zero row), the causal
//     diagonal in dkdv (there rows past Tk are never stored and columns
//     past Tq read lse2 = +inf, so P = 0).
//   - Registers bound the design: two blocks per SM leave 168 a thread,
//     and dkdv holds dK and dV (2 x D/2 f32) beside the scores and their
//     splits. So dkdv takes each 64-row query tile in two halves of 32
//     columns (m64n32 score products), and issues dV's products before it
//     splits dS^T, so they run while it does. Two blocks per SM overlap
//     one block's products with the other's exponentials and splits;
//     prep and dq run one 64 x 64 step at a time.
//
// f32 (`flash_bwd_{prep,dkdv,dq}_f32<D>`): the bf16 kernels' structure on
// split operands. q, k, v and dO arrive as three bf16 pieces each
// (hi, mid, lo from flash_attention.cu's `split_f32`, one launch before the
// three), P and dS are split the same way in registers, and every f32
// product runs as six bf16 wgmma piece products accumulated in f32 (about
// 2^-24 of each product's terms; TF32 would leave 2^-11, and bf16 keeps the
// transpose bit the MN-major operands need, which tf32 lacks). 9 f32
// products per tile pair (S and dP in each kernel, dV, dK, dQ): 54 bf16
// ones against the 5 x 6 of the bound. The pieces triple the tiles, so a
// block is one per SM: two consumer warpgroups over 128 fixed rows (query
// rows in prep and dq, keys in dkdv) that share each streamed pair, which
// halves the streamed loads and keeps the tensor cores busy through one
// warpgroup's exponentials and splits (one warpgroup where the fixed rows
// are 64 or fewer, as in the decoder); dkdv keeps the bf16 kernel's
// 32-column halves.

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;  // query rows per tile
constexpr int kBN = 64;  // keys per tile

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

// keys [0, end) that some row of the query tile starting at q0 sees
__device__ __forceinline__ int kv_end(int q0, const BwdArgs& a) {
  const int last = min(q0 + kBM, a.Tq) - 1;
  return a.causal ? min(max(last + a.Tk - a.Tq + 1, 0), a.Tk) : a.Tk;
}

// keys [0, n) that query row r sees
__device__ __forceinline__ int row_keys(int r, const BwdArgs& a) {
  return a.causal ? min(max(r + a.Tk - a.Tq + 1, 0), a.Tk) : a.Tk;
}

// the first query row that sees key k0 (causal), rounded down to its tile
__device__ __forceinline__ int first_q_tile(int k0, const BwdArgs& a) {
  return (a.causal ? max(k0 - (a.Tk - a.Tq), 0) : 0) / kBM * kBM;
}

// ── bf16: wgmma + TMA ───────────────────────────────────────────────────

constexpr int kStages = 2;     // streamed tile pairs in flight
constexpr int kThreads = 160;  // one consumer warpgroup, one producer warp
// dkdv works through each 64-row query tile in halves of 32 columns, so
// that dK, dV, the half's scores and their splits fit the 168 registers
// of two blocks per SM (10 warps, three on one SM sub-partition); whole
// 64-column steps need 184-200 and run at one block per SM, or spill
constexpr int kHalf = 32;

template <int D>
struct SmemBf16 {  // every tile starts on a 1024-byte boundary (the swizzle's period)
  __nv_bfloat16 fa[kBM * D];           // fixed: Q (prep, dq) or K (dkdv)
  __nv_bfloat16 fb[kBM * D];           // fixed: dO or V
  __nv_bfloat16 sa[kStages][kBN * D];  // streamed: K or Q
  __nv_bfloat16 sb[kStages][kBN * D];  // streamed: V or dO
  float lse2[kStages][kBM];            // dkdv: the streamed query rows' lse2 and delta
  float delta[kStages][kBM];
  uint64_t full[kStages];   // the pair has landed (TMA transaction bytes; dkdv: + 31 lanes' stats)
  uint64_t empty[kStages];  // every consumer warp is done with the pair
  uint64_t fixed_full;
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
// group (16*D bytes); the leading offset is unused by these layouts. The
// same descriptor reads the tile K-major (rows are M or N, D is the k
// axis) or MN-major (rows are the k axis, D is N).
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
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accumulator reads or writes across a wgmma
// issue or wait
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
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

// D[64 x 32] (+)= A[64 x 16] B[16 x 32]: A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// The split operand of a [64 x 16K] score tile held as accumulator
// fragments (element i: row g (i%4 < 2) or g + 8, column 8*(i/4) + 2t +
// i%2): per k-step c of 16 columns, the A fragments of hi = rn(x) and
// lo = rn(x - hi) (the fragments of columns 16c.. and 16c+8.. are A's two
// k halves).
template <int K>
struct Split {
  uint32_t hi[K][4];
  uint32_t lo[K][4];
};

__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);  // .x (x0) in the low half
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);  // x - hi is exact in f32
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int K>
__device__ __forceinline__ void split(const float (&x)[8 * K], Split<K>& out) {
#pragma unroll
  for (int c = 0; c < K; ++c)
#pragma unroll
    for (int r = 0; r < 4; ++r) split_pair(x[8 * c + 2 * r], x[8 * c + 2 * r + 1], out.hi[c][r], out.lo[c][r]);
}

// acc += X B, X as split A fragments (16 rows of B per k-step), B a tile
// as stored from b_addr on: D*32 bytes per k-step
template <int D, int K>
__device__ __forceinline__ void issue_split(float (&acc)[D / 2], const Split<K>& x, uint32_t b_addr) {
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const uint64_t b = smem_desc<D>(b_addr + c * 32 * D);
    if constexpr (D == 64) {
      wgmma_rs_n64(acc, x.hi[c], b);
      wgmma_rs_n64(acc, x.lo[c], b);
    } else {
      wgmma_rs_n32(acc, x.hi[c], b);
      wgmma_rs_n32(acc, x.lo[c], b);
    }
  }
}

// s = fa sa^T and dp = fb sb^T over D ([64 x N], f32, N the rows of sa
// and sb from their addresses on), issued and drained with no branch in
// between
template <int D, int N>
__device__ __forceinline__ void scores(float (&s)[N / 2], float (&dp)[N / 2], uint32_t fa,
                                       uint32_t fb, uint32_t sa, uint32_t sb) {
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    if constexpr (N == 64) {
      wgmma_ss_n64(s, smem_desc<D>(fa + 32 * c), smem_desc<D>(sa + 32 * c), c);
    } else {
      wgmma_ss_n32(s, smem_desc<D>(fa + 32 * c), smem_desc<D>(sa + 32 * c), c);
    }
  }
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    if constexpr (N == 64) {
      wgmma_ss_n64(dp, smem_desc<D>(fb + 32 * c), smem_desc<D>(sb + 32 * c), c);
    } else {
      wgmma_ss_n32(dp, smem_desc<D>(fb + 32 * c), smem_desc<D>(sb + 32 * c), c);
    }
  }
  wgmma_commit();
  wgmma_wait_all();
  pin(s);
  pin(dp);
}

__device__ __forceinline__ float exp2_approx(float x) {  // ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// a consumer warp is done with a stage
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
}

// rows r0 + warp*16 + g (+ 8) of a [n, D] bf16 output from accumulator
// fragments, times mul
template <int D>
__device__ __forceinline__ void store_acc(void* dst, const float (&acc)[D / 2], int r_lo, int n,
                                          int t, float mul) {
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(dst);
  const int r_hi = r_lo + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (r_lo < n) {
      *reinterpret_cast<uint32_t*>(out + (size_t)r_lo * D + col) =
          pack_bf16(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    }
    if (r_hi < n) {
      *reinterpret_cast<uint32_t*>(out + (size_t)r_hi * D + col) =
          pack_bf16(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
    }
  }
}

template <int D>
__device__ __forceinline__ SmemBf16<D>& smem_bf16() {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  return *reinterpret_cast<SmemBf16<D>*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                         ~static_cast<uintptr_t>(1023));
}

__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* empty, uint64_t* fixed_full,
                                              int full_count, int consumer_warps = 4) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], full_count);
      mbar_init(&empty[s], consumer_warps);
    }
    mbar_init(fixed_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer warp: the fixed pair (rows fixed_row) once, then n_steps
// streamed pairs from row first, 64 rows each. With kStats (dkdv) every lane
// stages the streamed rows' lse2 and delta (+inf and 0 at or past Tq) and
// arrives on the stage's full barrier; otherwise lane 0 alone issues.
template <int D, bool kStats>
__device__ __forceinline__ void produce(SmemBf16<D>& sm, const CUtensorMap* fa, const CUtensorMap* fb,
                                        const CUtensorMap* sa, const CUtensorMap* sb, int fixed_row,
                                        int slice, int first, int n_steps, const BwdArgs& a, int lane) {
  if (n_steps == 0 || (!kStats && lane != 0)) return;
  constexpr uint32_t kPairBytes = 2 * kBM * D * 2;
  if (lane == 0) {
    mbar_expect_tx(&sm.fixed_full, kPairBytes);
    tma_load(sm.fa, fa, &sm.fixed_full, fixed_row, slice);
    tma_load(sm.fb, fb, &sm.fixed_full, fixed_row, slice);
  }
  int stage = 0;
  uint32_t phase = 0;
  for (int j = 0; j < n_steps; ++j) {
    const int row = first + j * kBN;
    mbar_wait(&sm.empty[stage], phase ^ 1);  // the first round passes at once
    if (kStats) {
      const float* lse2 = a.lse2 + (size_t)slice * a.Tq;
      const float* delta = a.delta + (size_t)slice * a.Tq;
#pragma unroll
      for (int h = 0; h < kBM; h += 32) {
        const int r = row + h + lane;
        sm.lse2[stage][h + lane] = r < a.Tq ? lse2[r] : INFINITY;
        sm.delta[stage][h + lane] = r < a.Tq ? delta[r] : 0.f;
      }
    }
    if (lane == 0) {
      mbar_expect_tx(&sm.full[stage], kPairBytes);
      tma_load(sm.sa[stage], sa, &sm.full[stage], row, slice);
      tma_load(sm.sb[stage], sb, &sm.full[stage], row, slice);
    } else {
      mbar_arrive(&sm.full[stage]);  // releases this lane's stats
    }
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// ── 0: lse2 and delta ────────────────────────────────────────────────────

// three blocks per SM (91 registers, 51 KB of shared memory each at D = 64)
template <int D>
__global__ void __launch_bounds__(kThreads, 3)
flash_bwd_prep_bf16(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
                    const BwdArgs a) {
  SmemBf16<D>& sm = smem_bf16<D>();
  const int slice = blockIdx.z * a.H + blockIdx.y;  // (example, head): the maps' third coordinate
  const int q0 = blockIdx.x * kBM;
  const int n_steps = (kv_end(q0, a) + kBN - 1) / kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  init_barriers(sm.full, sm.empty, &sm.fixed_full, 1);
  if (warp == 4) {
    produce<D, false>(sm, &q_map, &do_map, &k_map, &v_map, q0, slice, 0, n_steps, a, lane);
    return;
  }

  // this thread's rows r_lo and r_hi of the accumulator fragments
  const int g = lane / 4, t = lane % 4;
  const int r_lo = q0 + warp * 16 + g, r_hi = r_lo + 8;
  // rows past Tq are computed on Q's zero fill and never stored
  const int n_lo = row_keys(min(r_lo, a.Tq - 1), a), n_hi = row_keys(min(r_hi, a.Tq - 1), a);
  const int all_see = row_keys(q0, a);  // tiles ending at or below it need no mask
  // running max (log2 units), sum of 2^(x - m) and sum of 2^(x - m) * dP
  // over this thread's quarter of each row; the max is the whole row's
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f, u_lo = 0.f, u_hi = 0.f;
  if (n_steps > 0) mbar_wait(&sm.fixed_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int j = 0; j < n_steps; ++j) {
    const int kv0 = j * kBN;
    mbar_wait(&sm.full[stage], phase);
    float s[kBN / 2], dp[kBN / 2];
    scores<D, kBN>(s, dp, smem_u32(sm.fa), smem_u32(sm.fb), smem_u32(sm.sa[stage]), smem_u32(sm.sb[stage]));
    release(&sm.empty[stage], lane);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) s[i] *= a.scale_log2;
    if (kv0 + kBN > all_see) {  // ragged tail, causal diagonal
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) {
        const int key = kv0 + 8 * (i / 4) + 2 * t + (i & 1);
        s[i] = key < ((i & 2) ? n_hi : n_lo) ? s[i] : -INFINITY;
      }
    }
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
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
    mx_lo = fmaxf(m_lo, mx_lo);
    mx_hi = fmaxf(m_hi, mx_hi);
    // a row that has seen no key keeps max -inf: exponentiate against 0
    const float ref_lo = mx_lo == -INFINITY ? 0.f : mx_lo;
    const float ref_hi = mx_hi == -INFINITY ? 0.f : mx_hi;
    const float c_lo = exp2_approx(m_lo - ref_lo), c_hi = exp2_approx(m_hi - ref_hi);
    m_lo = mx_lo;
    m_hi = mx_hi;
    l_lo *= c_lo;
    u_lo *= c_lo;
    l_hi *= c_hi;
    u_hi *= c_hi;
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      const float e = exp2_approx(s[i] - ((i & 2) ? ref_hi : ref_lo));
      if (i & 2) {
        l_hi += e;
        u_hi = fmaf(e, dp[i], u_hi);
      } else {
        l_lo += e;
        u_lo = fmaf(e, dp[i], u_lo);
      }
    }
  }
  // each thread holds a quarter of its two rows' sums, all against the row's max
#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    u_lo += __shfl_xor_sync(0xffffffffu, u_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    u_hi += __shfl_xor_sync(0xffffffffu, u_hi, off);
  }
  if (t == 0) {
    float* lse2 = a.lse2 + (size_t)slice * a.Tq;
    float* delta = a.delta + (size_t)slice * a.Tq;
    if (r_lo < a.Tq) {
      lse2[r_lo] = l_lo > 0.f ? m_lo + log2f(l_lo) : INFINITY;
      delta[r_lo] = l_lo > 0.f ? u_lo / l_lo : 0.f;
    }
    if (r_hi < a.Tq) {
      lse2[r_hi] = l_hi > 0.f ? m_hi + log2f(l_hi) : INFINITY;
      delta[r_hi] = l_hi > 0.f ? u_hi / l_hi : 0.f;
    }
  }
}

// ── 1: dK and dV ─────────────────────────────────────────────────────────

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkdv_bf16(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
                    const BwdArgs a) {
  SmemBf16<D>& sm = smem_bf16<D>();
  const int slice = blockIdx.z * a.H + blockIdx.y;
  const int k0 = blockIdx.x * kBN;
  const int first = first_q_tile(k0, a);
  const int n_steps = first < a.Tq ? (a.Tq - first + kBM - 1) / kBM : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  init_barriers(sm.full, sm.empty, &sm.fixed_full, 32);
  if (warp == 4) {
    produce<D, true>(sm, &k_map, &v_map, &q_map, &do_map, k0, slice, first, n_steps, a, lane);
    return;
  }

  // accumulator rows are keys, columns query rows
  const int g = lane / 4, t = lane % 4;
  const int key_lo = k0 + warp * 16 + g, key_hi = key_lo + 8;
  const int offs = a.Tk - a.Tq;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  if (n_steps > 0) mbar_wait(&sm.fixed_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int j = 0; j < n_steps; ++j) {
    const int q0 = first + j * kBM;
    mbar_wait(&sm.full[stage], phase);
    const bool diag = a.causal && k0 + kBN - 1 > q0 + offs;  // the diagonal: key <= q + offs
#pragma unroll
    for (int h = 0; h < kBM / kHalf; ++h) {  // query rows kHalf * h.. of the tile
      const uint32_t q_addr = smem_u32(sm.sa[stage]) + h * kHalf * D * 2;
      const uint32_t do_addr = smem_u32(sm.sb[stage]) + h * kHalf * D * 2;
      const float* lse2 = sm.lse2[stage] + h * kHalf;
      const float* delta = sm.delta[stage] + h * kHalf;
      float p[kHalf / 2], ds[kHalf / 2];  // S^T, then P^T; dP^T, then dS^T
      scores<D, kHalf>(p, ds, smem_u32(sm.fa), smem_u32(sm.fb), q_addr, do_addr);
      // P^T = 2^(S^T * scale_log2 - lse2[q]): columns at or past Tq read
      // lse2 = +inf, so 0
#pragma unroll
      for (int c = 0; c < kHalf / 8; ++c) {
        const float2 lse = *reinterpret_cast<const float2*>(&lse2[8 * c + 2 * t]);
        p[4 * c + 0] = exp2_approx(fmaf(p[4 * c + 0], a.scale_log2, -lse.x));
        p[4 * c + 1] = exp2_approx(fmaf(p[4 * c + 1], a.scale_log2, -lse.y));
        p[4 * c + 2] = exp2_approx(fmaf(p[4 * c + 2], a.scale_log2, -lse.x));
        p[4 * c + 3] = exp2_approx(fmaf(p[4 * c + 3], a.scale_log2, -lse.y));
      }
      if (diag) {
#pragma unroll
        for (int i = 0; i < kHalf / 2; ++i) {
          const int q = q0 + h * kHalf + 8 * (i / 4) + 2 * t + (i & 1);
          p[i] = ((i & 2) ? key_hi : key_lo) <= q + offs ? p[i] : 0.f;
        }
      }
#pragma unroll
      for (int c = 0; c < kHalf / 8; ++c) {
        const float2 dl = *reinterpret_cast<const float2*>(&delta[8 * c + 2 * t]);
        ds[4 * c + 0] = p[4 * c + 0] * (ds[4 * c + 0] - dl.x);
        ds[4 * c + 1] = p[4 * c + 1] * (ds[4 * c + 1] - dl.y);
        ds[4 * c + 2] = p[4 * c + 2] * (ds[4 * c + 2] - dl.x);
        ds[4 * c + 3] = p[4 * c + 3] * (ds[4 * c + 3] - dl.y);
      }
      // P^T's split goes to the tensor cores while dS^T's is made
      Split<kHalf / 16> ps, dss;
      split(p, ps);
      wgmma_fence();
      issue_split<D>(dv, ps, do_addr);  // dV += P^T dO
      wgmma_commit();
      split(ds, dss);
      wgmma_fence();
      issue_split<D>(dk, dss, q_addr);  // dK += dS^T Q
      wgmma_commit();
      wgmma_wait_all();
      pin(dv);
      pin(dk);
    }
    release(&sm.empty[stage], lane);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  store_acc<D>(static_cast<__nv_bfloat16*>(a.dk) + (size_t)slice * a.Tk * D, dk, key_lo, a.Tk, t, a.scale);
  store_acc<D>(static_cast<__nv_bfloat16*>(a.dv) + (size_t)slice * a.Tk * D, dv, key_lo, a.Tk, t, 1.f);
}

// ── 2: dQ ────────────────────────────────────────────────────────────────

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
                  const BwdArgs a) {
  SmemBf16<D>& sm = smem_bf16<D>();
  const int slice = blockIdx.z * a.H + blockIdx.y;
  const int q0 = blockIdx.x * kBM;
  const int n_steps = (kv_end(q0, a) + kBN - 1) / kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  init_barriers(sm.full, sm.empty, &sm.fixed_full, 1);
  if (warp == 4) {
    produce<D, false>(sm, &q_map, &do_map, &k_map, &v_map, q0, slice, 0, n_steps, a, lane);
    return;
  }

  const int g = lane / 4, t = lane % 4;
  const int r_lo = q0 + warp * 16 + g, r_hi = r_lo + 8;
  const int n_lo = row_keys(min(r_lo, a.Tq - 1), a), n_hi = row_keys(min(r_hi, a.Tq - 1), a);
  const int all_see = row_keys(q0, a);
  // the rows' stats; rows past Tq: P = 0
  const float* lse2 = a.lse2 + (size_t)slice * a.Tq;
  const float* delta = a.delta + (size_t)slice * a.Tq;
  const float lse_lo = r_lo < a.Tq ? lse2[r_lo] : INFINITY, lse_hi = r_hi < a.Tq ? lse2[r_hi] : INFINITY;
  const float dl_lo = r_lo < a.Tq ? delta[r_lo] : 0.f, dl_hi = r_hi < a.Tq ? delta[r_hi] : 0.f;
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  if (n_steps > 0) mbar_wait(&sm.fixed_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int j = 0; j < n_steps; ++j) {
    const int kv0 = j * kBN;
    mbar_wait(&sm.full[stage], phase);
    float p[kBN / 2], ds[kBN / 2];
    scores<D, kBN>(p, ds, smem_u32(sm.fa), smem_u32(sm.fb), smem_u32(sm.sa[stage]), smem_u32(sm.sb[stage]));
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) p[i] = exp2_approx(fmaf(p[i], a.scale_log2, (i & 2) ? -lse_hi : -lse_lo));
    if (kv0 + kBN > all_see) {  // ragged tail, causal diagonal
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) {
        const int key = kv0 + 8 * (i / 4) + 2 * t + (i & 1);
        p[i] = key < ((i & 2) ? n_hi : n_lo) ? p[i] : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) ds[i] = p[i] * (ds[i] - ((i & 2) ? dl_hi : dl_lo));
    Split<kBN / 16> dss;
    split(ds, dss);
    wgmma_fence();
    issue_split<D>(dq, dss, smem_u32(sm.sa[stage]));  // dQ += dS K
    wgmma_commit();
    wgmma_wait_all();
    pin(dq);
    release(&sm.empty[stage], lane);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  store_acc<D>(static_cast<__nv_bfloat16*>(a.dq) + (size_t)slice * a.Tq * D, dq, r_lo, a.Tq, t, a.scale);
}

// ── f32: split operands on the tensor cores ─────────────────────────────

// As in flash_attention.cu: each f32 operand goes in as three bf16 pieces
// (hi, mid, lo; the tiles from split_f32's planes, P and dS split in
// registers) and a product as the six piece products hl, lh, mm, hm, mh,
// hh accumulated in f32, smallest first. Product i multiplies A's piece
// piece_a(i) by B's piece piece_b(i).
constexpr int kPieces = 3;
constexpr int kSplitProducts = 6;
__host__ __device__ constexpr int piece_a(int i) { return i == 1 ? 2 : i == 2 || i == 4 ? 1 : 0; }
__host__ __device__ constexpr int piece_b(int i) { return i == 0 ? 2 : i == 2 || i == 3 ? 1 : 0; }

// A block is W consumer warpgroups, each over its own 64-row fixed pair,
// sharing the streamed tiles, and one producer warp.
template <int W>
constexpr int f32_threads() {
  return 32 * (4 * W + 1);
}
template <int D, int W>
struct SmemF32 {  // every tile starts on a 1024-byte boundary; a tile's pieces follow each other
  __nv_bfloat16 fa[W][kPieces][kBM * D];
  __nv_bfloat16 fb[W][kPieces][kBM * D];
  __nv_bfloat16 sa[kStages][kPieces][kBN * D];
  __nv_bfloat16 sb[kStages][kPieces][kBN * D];
  float lse2[kStages][kBM];
  float delta[kStages][kBM];
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t fixed_full;
};

template <int D, int W>
__device__ __forceinline__ SmemF32<D, W>& smem_f32() {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  return *reinterpret_cast<SmemF32<D, W>*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                           ~static_cast<uintptr_t>(1023));
}

// keys [0, end) that some row of the block of `rows` rows starting at q0 sees
__device__ __forceinline__ int kv_end_f32(int q0, int rows, const BwdArgs& a) {
  const int last = min(q0 + rows, a.Tq) - 1;
  return a.causal ? min(max(last + a.Tk - a.Tq + 1, 0), a.Tk) : a.Tk;
}

// produce() over the pieces (piece p of a tile is at slice + p * slices)
// and every warpgroup's fixed pair (rows fixed_row + 64 w)
template <int D, int W, bool kStats>
__device__ __forceinline__ void produce_f32(SmemF32<D, W>& sm, const CUtensorMap* fa, const CUtensorMap* fb,
                                            const CUtensorMap* sa, const CUtensorMap* sb, int fixed_row,
                                            int slice, int slices, int first, int n_steps, const BwdArgs& a,
                                            int lane) {
  if (n_steps == 0 || (!kStats && lane != 0)) return;
  constexpr uint32_t kPairBytes = 2 * kPieces * kBM * D * 2;
  if (lane == 0) {
    mbar_expect_tx(&sm.fixed_full, W * kPairBytes);
#pragma unroll
    for (int w = 0; w < W; ++w) {
#pragma unroll
      for (int p = 0; p < kPieces; ++p) {
        tma_load(sm.fa[w][p], fa, &sm.fixed_full, fixed_row + w * kBM, slice + p * slices);
        tma_load(sm.fb[w][p], fb, &sm.fixed_full, fixed_row + w * kBM, slice + p * slices);
      }
    }
  }
  int stage = 0;
  uint32_t phase = 0;
  for (int j = 0; j < n_steps; ++j) {
    const int row = first + j * kBN;
    mbar_wait(&sm.empty[stage], phase ^ 1);  // the first round passes at once
    if (kStats) {
      const float* lse2 = a.lse2 + (size_t)slice * a.Tq;
      const float* delta = a.delta + (size_t)slice * a.Tq;
#pragma unroll
      for (int h = 0; h < kBM; h += 32) {
        const int r = row + h + lane;
        sm.lse2[stage][h + lane] = r < a.Tq ? lse2[r] : INFINITY;
        sm.delta[stage][h + lane] = r < a.Tq ? delta[r] : 0.f;
      }
    }
    if (lane == 0) {
      mbar_expect_tx(&sm.full[stage], kPairBytes);
#pragma unroll
      for (int p = 0; p < kPieces; ++p) {
        tma_load(sm.sa[stage][p], sa, &sm.full[stage], row, slice + p * slices);
        tma_load(sm.sb[stage][p], sb, &sm.full[stage], row, slice + p * slices);
      }
    } else {
      mbar_arrive(&sm.full[stage]);  // releases this lane's stats
    }
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// scores() over the pieces: s = fa sa^T and dp = fb sb^T ([64 x N]) as six
// piece products each; a piece of a fixed tile is kBM * D * 2 bytes after
// the one before, of a streamed tile kBN * D * 2
template <int D, int N>
__device__ __forceinline__ void scores_f32(float (&s)[N / 2], float (&dp)[N / 2], uint32_t fa,
                                           uint32_t fb, uint32_t sa, uint32_t sb) {
  constexpr uint32_t kF = kBM * D * 2, kS = kBN * D * 2;
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < kSplitProducts; ++i) {
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const uint64_t x = smem_desc<D>(fa + piece_a(i) * kF + 32 * c);
      const uint64_t y = smem_desc<D>(sa + piece_b(i) * kS + 32 * c);
      if constexpr (N == 64) {
        wgmma_ss_n64(s, x, y, i + c);
      } else {
        wgmma_ss_n32(s, x, y, i + c);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kSplitProducts; ++i) {
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const uint64_t x = smem_desc<D>(fb + piece_a(i) * kF + 32 * c);
      const uint64_t y = smem_desc<D>(sb + piece_b(i) * kS + 32 * c);
      if constexpr (N == 64) {
        wgmma_ss_n64(dp, x, y, i + c);
      } else {
        wgmma_ss_n32(dp, x, y, i + c);
      }
    }
  }
  wgmma_commit();
  wgmma_wait_all();
  pin(s);
  pin(dp);
}

// the three pieces of a score tile's accumulator fragments, as A fragments
// per k-step of 16 columns (see Split)
template <int K>
struct Split3 {
  uint32_t p[kPieces][K][4];
};

__device__ __forceinline__ void split_pair3(float x0, float x1, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);  // .x (x0) in the low half
  const float2 hf = __bfloat1622float2(h);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;  // exact in f32
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(r0 - mf.x, r1 - mf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int K>
__device__ __forceinline__ void split3(const float (&x)[8 * K], Split3<K>& out) {
#pragma unroll
  for (int c = 0; c < K; ++c)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_pair3(x[8 * c + 2 * r], x[8 * c + 2 * r + 1], out.p[0][c][r], out.p[1][c][r], out.p[2][c][r]);
}

// acc += X B over the six piece products: X the split register operand, B
// a streamed tile's pieces as stored from b_addr on (kBN * D * 2 bytes
// apart), D*32 bytes per k-step
template <int D, int K>
__device__ __forceinline__ void issue_split3(float (&acc)[D / 2], const Split3<K>& x, uint32_t b_addr) {
  constexpr uint32_t kS = kBN * D * 2;
#pragma unroll
  for (int i = 0; i < kSplitProducts; ++i) {
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const uint64_t b = smem_desc<D>(b_addr + piece_b(i) * kS + c * 32 * D);
      if constexpr (D == 64) {
        wgmma_rs_n64(acc, x.p[piece_a(i)][c], b);
      } else {
        wgmma_rs_n32(acc, x.p[piece_a(i)][c], b);
      }
    }
  }
}

// rows r0 + warp*16 + g (+ 8) of a [n, D] f32 output from accumulator
// fragments, times mul
template <int D>
__device__ __forceinline__ void store_acc_f32(float* out, const float (&acc)[D / 2], int r_lo, int n,
                                              int t, float mul) {
  const int r_hi = r_lo + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (r_lo < n) {
      *reinterpret_cast<float2*>(out + (size_t)r_lo * D + col) = make_float2(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    }
    if (r_hi < n) {
      *reinterpret_cast<float2*>(out + (size_t)r_hi * D + col) =
          make_float2(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
    }
  }
}

// The three f32 kernels are the bf16 ones over pieces: 12 products per
// score pair, 6 per product with P or dS. A block is W consumer warpgroups
// over W x 64 fixed rows that share each streamed pair (W fixed pairs and
// two stages of streamed pairs: 145 KB at D = 64 and W = 1, 193 KB at
// W = 2; one block per SM); prep and dq hold whole 64-column steps and
// dkdv works in column slices of kHalf. With W = 2 (9 warps, three on
// one SM sub-partition) ptxas allows 168 registers, and dkdv spills about
// 400 bytes there; it still measured 13% faster than W = 1 at the encoder
// shape (PERF.md), the second warpgroup's products running beside the
// first one's exponentials and splits.

template <int D, int W>
__global__ void __launch_bounds__(f32_threads<W>(), 1)
flash_bwd_prep_f32(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
                   const BwdArgs a) {
  SmemF32<D, W>& sm = smem_f32<D, W>();
  const int slices = gridDim.z * a.H;
  const int slice = blockIdx.z * a.H + blockIdx.y;
  const int q0 = blockIdx.x * W * kBM;
  const int n_steps = (kv_end_f32(q0, W * kBM, a) + kBN - 1) / kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  init_barriers(sm.full, sm.empty, &sm.fixed_full, 1, 4 * W);
  if (warp == 4 * W) {
    produce_f32<D, W, false>(sm, &q_map, &do_map, &k_map, &v_map, q0, slice, slices, 0, n_steps, a, lane);
    return;
  }

  // warpgroup wg owns rows q0 + 64 wg..; rows past Tq compute on zeros, unstored
  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  const int r_lo = q0 + wg * kBM + (warp % 4) * 16 + g, r_hi = r_lo + 8;
  const int n_lo = row_keys(min(r_lo, a.Tq - 1), a), n_hi = row_keys(min(r_hi, a.Tq - 1), a);
  const int all_see = row_keys(min(q0 + wg * kBM, a.Tq - 1), a);
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f, u_lo = 0.f, u_hi = 0.f;
  if (n_steps > 0) mbar_wait(&sm.fixed_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int j = 0; j < n_steps; ++j) {
    const int kv0 = j * kBN;
    mbar_wait(&sm.full[stage], phase);
    float s[kBN / 2], dp[kBN / 2];
    scores_f32<D, kBN>(s, dp, smem_u32(sm.fa[wg][0]), smem_u32(sm.fb[wg][0]), smem_u32(sm.sa[stage][0]),
                       smem_u32(sm.sb[stage][0]));
    release(&sm.empty[stage], lane);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) s[i] *= a.scale_log2;
    if (kv0 + kBN > all_see) {  // ragged tail, causal diagonal
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) {
        const int key = kv0 + 8 * (i / 4) + 2 * t + (i & 1);
        s[i] = key < ((i & 2) ? n_hi : n_lo) ? s[i] : -INFINITY;
      }
    }
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      if (i & 2) {
        mx_hi = fmaxf(mx_hi, s[i]);
      } else {
        mx_lo = fmaxf(mx_lo, s[i]);
      }
    }
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    mx_lo = fmaxf(m_lo, mx_lo);
    mx_hi = fmaxf(m_hi, mx_hi);
    const float ref_lo = mx_lo == -INFINITY ? 0.f : mx_lo;
    const float ref_hi = mx_hi == -INFINITY ? 0.f : mx_hi;
    const float c_lo = exp2_approx(m_lo - ref_lo), c_hi = exp2_approx(m_hi - ref_hi);
    m_lo = mx_lo;
    m_hi = mx_hi;
    l_lo *= c_lo;
    u_lo *= c_lo;
    l_hi *= c_hi;
    u_hi *= c_hi;
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      const float e = exp2_approx(s[i] - ((i & 2) ? ref_hi : ref_lo));
      if (i & 2) {
        l_hi += e;
        u_hi = fmaf(e, dp[i], u_hi);
      } else {
        l_lo += e;
        u_lo = fmaf(e, dp[i], u_lo);
      }
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    u_lo += __shfl_xor_sync(0xffffffffu, u_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    u_hi += __shfl_xor_sync(0xffffffffu, u_hi, off);
  }
  if (t == 0) {
    float* lse2 = a.lse2 + (size_t)slice * a.Tq;
    float* delta = a.delta + (size_t)slice * a.Tq;
    if (r_lo < a.Tq) {
      lse2[r_lo] = l_lo > 0.f ? m_lo + log2f(l_lo) : INFINITY;
      delta[r_lo] = l_lo > 0.f ? u_lo / l_lo : 0.f;
    }
    if (r_hi < a.Tq) {
      lse2[r_hi] = l_hi > 0.f ? m_hi + log2f(l_hi) : INFINITY;
      delta[r_hi] = l_hi > 0.f ? u_hi / l_hi : 0.f;
    }
  }
}

template <int D, int W>
__global__ void __launch_bounds__(f32_threads<W>(), 1)
flash_bwd_dkdv_f32(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
                   const BwdArgs a) {
  SmemF32<D, W>& sm = smem_f32<D, W>();
  const int slices = gridDim.z * a.H;
  const int slice = blockIdx.z * a.H + blockIdx.y;
  const int k0 = blockIdx.x * W * kBN;
  const int first = first_q_tile(k0, a);
  const int n_steps = first < a.Tq ? (a.Tq - first + kBM - 1) / kBM : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  init_barriers(sm.full, sm.empty, &sm.fixed_full, 32, 4 * W);
  if (warp == 4 * W) {
    produce_f32<D, W, true>(sm, &k_map, &v_map, &q_map, &do_map, k0, slice, slices, first, n_steps, a, lane);
    return;
  }

  // warpgroup wg owns keys k0 + 64 wg..
  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  const int kw = k0 + wg * kBN;
  const int key_lo = kw + (warp % 4) * 16 + g, key_hi = key_lo + 8;
  const int offs = a.Tk - a.Tq;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  if (n_steps > 0) mbar_wait(&sm.fixed_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int j = 0; j < n_steps; ++j) {
    const int q0 = first + j * kBM;
    mbar_wait(&sm.full[stage], phase);
    const bool diag = a.causal && kw + kBN - 1 > q0 + offs;
#pragma unroll
    for (int h = 0; h < kBM / kHalf; ++h) {
      const uint32_t q_addr = smem_u32(sm.sa[stage][0]) + h * kHalf * D * 2;
      const uint32_t do_addr = smem_u32(sm.sb[stage][0]) + h * kHalf * D * 2;
      const float* lse2 = sm.lse2[stage] + h * kHalf;
      const float* delta = sm.delta[stage] + h * kHalf;
      float p[kHalf / 2], ds[kHalf / 2];
      scores_f32<D, kHalf>(p, ds, smem_u32(sm.fa[wg][0]), smem_u32(sm.fb[wg][0]), q_addr, do_addr);
#pragma unroll
      for (int c = 0; c < kHalf / 8; ++c) {
        const float2 lse = *reinterpret_cast<const float2*>(&lse2[8 * c + 2 * t]);
        p[4 * c + 0] = exp2_approx(fmaf(p[4 * c + 0], a.scale_log2, -lse.x));
        p[4 * c + 1] = exp2_approx(fmaf(p[4 * c + 1], a.scale_log2, -lse.y));
        p[4 * c + 2] = exp2_approx(fmaf(p[4 * c + 2], a.scale_log2, -lse.x));
        p[4 * c + 3] = exp2_approx(fmaf(p[4 * c + 3], a.scale_log2, -lse.y));
      }
      if (diag) {
#pragma unroll
        for (int i = 0; i < kHalf / 2; ++i) {
          const int q = q0 + h * kHalf + 8 * (i / 4) + 2 * t + (i & 1);
          p[i] = ((i & 2) ? key_hi : key_lo) <= q + offs ? p[i] : 0.f;
        }
      }
#pragma unroll
      for (int c = 0; c < kHalf / 8; ++c) {
        const float2 dl = *reinterpret_cast<const float2*>(&delta[8 * c + 2 * t]);
        ds[4 * c + 0] = p[4 * c + 0] * (ds[4 * c + 0] - dl.x);
        ds[4 * c + 1] = p[4 * c + 1] * (ds[4 * c + 1] - dl.y);
        ds[4 * c + 2] = p[4 * c + 2] * (ds[4 * c + 2] - dl.x);
        ds[4 * c + 3] = p[4 * c + 3] * (ds[4 * c + 3] - dl.y);
      }
      // P^T's pieces go to the tensor cores while dS^T's are made
      Split3<kHalf / 16> ps, dss;
      split3(p, ps);
      wgmma_fence();
      issue_split3<D>(dv, ps, do_addr);  // dV += P^T dO
      wgmma_commit();
      split3(ds, dss);
      wgmma_fence();
      issue_split3<D>(dk, dss, q_addr);  // dK += dS^T Q
      wgmma_commit();
      wgmma_wait_all();
      pin(dv);
      pin(dk);
    }
    release(&sm.empty[stage], lane);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  store_acc_f32<D>(static_cast<float*>(a.dk) + (size_t)slice * a.Tk * D, dk, key_lo, a.Tk, t, a.scale);
  store_acc_f32<D>(static_cast<float*>(a.dv) + (size_t)slice * a.Tk * D, dv, key_lo, a.Tk, t, 1.f);
}

template <int D, int W>
__global__ void __launch_bounds__(f32_threads<W>(), 1)
flash_bwd_dq_f32(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
                 const BwdArgs a) {
  SmemF32<D, W>& sm = smem_f32<D, W>();
  const int slices = gridDim.z * a.H;
  const int slice = blockIdx.z * a.H + blockIdx.y;
  const int q0 = blockIdx.x * W * kBM;
  const int n_steps = (kv_end_f32(q0, W * kBM, a) + kBN - 1) / kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  init_barriers(sm.full, sm.empty, &sm.fixed_full, 1, 4 * W);
  if (warp == 4 * W) {
    produce_f32<D, W, false>(sm, &q_map, &do_map, &k_map, &v_map, q0, slice, slices, 0, n_steps, a, lane);
    return;
  }

  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  const int r_lo = q0 + wg * kBM + (warp % 4) * 16 + g, r_hi = r_lo + 8;
  const int n_lo = row_keys(min(r_lo, a.Tq - 1), a), n_hi = row_keys(min(r_hi, a.Tq - 1), a);
  const int all_see = row_keys(min(q0 + wg * kBM, a.Tq - 1), a);
  const float* lse2 = a.lse2 + (size_t)slice * a.Tq;
  const float* delta = a.delta + (size_t)slice * a.Tq;
  const float lse_lo = r_lo < a.Tq ? lse2[r_lo] : INFINITY, lse_hi = r_hi < a.Tq ? lse2[r_hi] : INFINITY;
  const float dl_lo = r_lo < a.Tq ? delta[r_lo] : 0.f, dl_hi = r_hi < a.Tq ? delta[r_hi] : 0.f;
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  if (n_steps > 0) mbar_wait(&sm.fixed_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int j = 0; j < n_steps; ++j) {
    const int kv0 = j * kBN;
    mbar_wait(&sm.full[stage], phase);
    float p[kBN / 2], ds[kBN / 2];
    scores_f32<D, kBN>(p, ds, smem_u32(sm.fa[wg][0]), smem_u32(sm.fb[wg][0]), smem_u32(sm.sa[stage][0]),
                       smem_u32(sm.sb[stage][0]));
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) p[i] = exp2_approx(fmaf(p[i], a.scale_log2, (i & 2) ? -lse_hi : -lse_lo));
    if (kv0 + kBN > all_see) {  // ragged tail, causal diagonal
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) {
        const int key = kv0 + 8 * (i / 4) + 2 * t + (i & 1);
        p[i] = key < ((i & 2) ? n_hi : n_lo) ? p[i] : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) ds[i] = p[i] * (ds[i] - ((i & 2) ? dl_hi : dl_lo));
    Split3<kBN / 16> dss;
    split3(ds, dss);
    wgmma_fence();
    issue_split3<D>(dq, dss, smem_u32(sm.sa[stage][0]));  // dQ += dS K
    wgmma_commit();
    wgmma_wait_all();
    pin(dq);
    release(&sm.empty[stage], lane);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  store_acc_f32<D>(static_cast<float*>(a.dq) + (size_t)slice * a.Tq * D, dq, r_lo, a.Tq, t, a.scale);
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

// a [slices, T, D] bf16 tensor in boxes of 64 rows x D, swizzled for
// wgmma; rows past T read as zeros
bool encode_map(CUtensorMap* map, const void* base, int D, int T, int slices) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)slices};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)T * D * 2};  // bytes
  const cuuint32_t box[3] = {(cuuint32_t)D, (cuuint32_t)kBM, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            D == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_bf16(int stage, const BwdArgs& a, int B, cudaStream_t s) {
  CUtensorMap maps[4];
  const int slices = B * a.H;
  if (!encode_map(&maps[0], a.q, D, a.Tq, slices) || !encode_map(&maps[1], a.k, D, a.Tk, slices) ||
      !encode_map(&maps[2], a.v, D, a.Tk, slices) || !encode_map(&maps[3], a.dout, D, a.Tq, slices)) {
    return cudaErrorInvalidValue;
  }
  const auto kernel = stage == 0   ? flash_bwd_prep_bf16<D>
                      : stage == 1 ? flash_bwd_dkdv_bf16<D>
                                   : flash_bwd_dq_bf16<D>;
  constexpr int smem = sizeof(SmemBf16<D>) + 1024;  // + the 1024-byte alignment
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(stage == 1 ? (a.Tk + kBN - 1) / kBN : (a.Tq + kBM - 1) / kBM, a.H, B);
  kernel<<<grid, kThreads, smem, s>>>(maps[0], maps[1], maps[2], maps[3], a);
  return cudaGetLastError();
}

template <int D, int W, typename Kernel>
cudaError_t run_f32(Kernel kernel, const BwdArgs& a, int B, int rows, const CUtensorMap (&maps)[4],
                    cudaStream_t s) {
  constexpr int smem = sizeof(SmemF32<D, W>) + 1024;  // + the 1024-byte alignment
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((rows + W * kBM - 1) / (W * kBM), a.H, B);
  kernel<<<grid, f32_threads<W>(), smem, s>>>(maps[0], maps[1], maps[2], maps[3], a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(int stage, const BwdArgs& a, int B, cudaStream_t s) {
  CUtensorMap maps[4];  // over the pieces: [3 * B*H, T, D] bf16
  const int slices = kPieces * B * a.H;
  if (!encode_map(&maps[0], a.q, D, a.Tq, slices) || !encode_map(&maps[1], a.k, D, a.Tk, slices) ||
      !encode_map(&maps[2], a.v, D, a.Tk, slices) || !encode_map(&maps[3], a.dout, D, a.Tq, slices)) {
    return cudaErrorInvalidValue;
  }
  // two warpgroups where the fixed rows (query rows; keys in dkdv) fill more
  // than one: the decoder's 64-row tiles would leave half of each block idle
  const int rows = stage == 1 ? a.Tk : a.Tq;
  if (rows > kBM) {
    const auto kernel = stage == 0   ? flash_bwd_prep_f32<D, 2>
                        : stage == 1 ? flash_bwd_dkdv_f32<D, 2>
                                     : flash_bwd_dq_f32<D, 2>;
    return run_f32<D, 2>(kernel, a, B, rows, maps, s);
  }
  const auto kernel = stage == 0   ? flash_bwd_prep_f32<D, 1>
                      : stage == 1 ? flash_bwd_dkdv_f32<D, 1>
                                   : flash_bwd_dq_f32<D, 1>;
  return run_f32<D, 1>(kernel, a, B, rows, maps, s);
}

}  // namespace

// One of the three passes of K1's backward: stage 0 writes lse2 and delta
// ([B,H,Tq] f32 scratch), stage 1 dk and dv, stage 2 dq (both read lse2 and
// delta). dtype: 0 = float32 (q, k, v and dout: their bf16 pieces
// [3,B,H,T,D] from os_split_f32; dq, dk, dv float32), 1 = bfloat16.
// Returns a cudaError_t (0 = launched).
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
    return (int)(D == 64 ? launch_bf16<64>(stage, a, B, s) : launch_bf16<32>(stage, a, B, s));
  }
  return (int)(D == 64 ? launch_f32<64>(stage, a, B, s) : launch_f32<32>(stage, a, B, s));
}
