// Flash attention for Hopper's tensor cores (sm_90a), bfloat16 at head dims
// 64, 112 and 128: blockwise online-softmax attention with grouped-query heads, a
// causal mask aligned at the sequence ends and an optional sliding window.
//
// Replaces the Pallas TPU kernel `_fa_kernel` (src/repro/kernels/
// flash_attention/kernel.py:25), launched by `flash_attention` (:77), on the
// port's main path: every bfloat16 call at D 64, 112 or 128.  Float32 and D
// 16 or 32 stay on the SIMT kernel of csrc/flash_attention.cu.  Plain version:
// src/repro_torch/kernels/flash_attention/ref.py.  Binding:
// src/repro_torch/kernels/flash_attention/kernel.py (ctypes); the route is
// chosen there, by dtype and head dim only.
//
// What it computes is ref.attention's function, as the SIMT kernel does.  q
// (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), each read at its own strides
// (the heads view of a (B, S, H*D) projection is never copied); query head h
// reads key/value head h / (Hq / Hkv).  Row i sits at q_pos = i + Skv - Sq;
// key j is kept when j <= q_pos (causal) and j > q_pos - window.  Scores are
// scaled in float32 after the product, then masked: a masked logit is the
// finite -1e30, never -inf, so a row whose first tiles are all masked
// carries exp(0) = 1 terms until a real key wipes them, and a row that sees
// no key (causal, Sq > Skv) gets the mean of v over every key.  Keys past
// Skv are absent, not masked: TMA fills their rows with zeros, and their
// scores are forced to -inf before the row max.  Output (B, Hq, Sq, D)
// contiguous.
//
// What bounds it.  4 * D operations per visible (query, key) pair: 687 GFLOP
// for q (4, 40, 4096, 128) causal, 0.695 ms at the H100's 989 TFLOP/s of
// dense bfloat16, against 0.40 GB of inputs and outputs (0.12 ms at 3.35
// TB/s): bound by operations, so the products belong on the tensor cores.
//
// Design, after FlashAttention-3 without its ping-pong and intra-warpgroup
// overlap.  One block per (batch * query head, 128-row query tile), the query
// heads that share a KV head side by side in blockIdx.x so their K/V tiles
// are read from L2, and the heaviest causal tiles first (blockIdx.y counts
// down).  Three warpgroups: warpgroup 0 gives up registers (setmaxnreg 40)
// and one of its threads issues every TMA load; warpgroups 1 and 2 take 232
// registers each and own query rows 0-63 and 64-127.  Shared memory: the Q
// tile (32 KB at D 128) and a ring of NS = 2 stages of BK = 128 keys of K
// and V (64 KB a stage at D 128): 160 KB.  "Full" mbarriers complete on the
// TMA transaction count, "empty" ones when all 256 consumer threads have
// arrived.  Every tile is stored as 64-column boxes of 128-byte rows under
// TMA's 128-byte swizzle, which the wgmma descriptors name (layout 1).  Per
// key tile a consumer warpgroup runs
//   S = Q K^T   wgmma m64n128k16, A = Q and B = K from shared memory, both
//               K-major: the descriptor steps 32 bytes per k-slice of 16
//               inside a swizzle atom, and 16 KB to the second 64-column box
//               at k = 64;
//   softmax     in registers, in the log2 domain: row max over the 4 lanes
//               that share a row, running max and denominator in float32,
//               the denominator summed from the unrounded float32 p.  Tiles
//               that no mask touches fold scale * log2(e) into one FMA per
//               score before ex2.approx.ftz; edge tiles scale, then mask,
//               then subtract the max exactly, so that -1e30 - -1e30 = 0;
//   O += P V    wgmma m64nDk16 with A = P rounded to bfloat16 in registers
//               (the accumulator's fragment is the A operand's, so it
//               converts in place) and B = V from shared memory, MN-major
//               through the descriptor's transpose bit (leading byte offset
//               = the next 64 columns of D, stride byte offset = the next 8
//               keys).
// O stays in float32 registers; the epilogue writes O / l (l == 0 -> 1) as
// bfloat16.  Where it rounds: q, k and v are bfloat16, and a bfloat16 x
// bfloat16 product is exact in float32, so S differs from the SIMT kernel's
// only in the order of its sums; P -> bfloat16 before P V is the one new
// rounding (unit roundoff 2^-8), bounded per output by 2^-8 times the plain
// attention of |v|; then the output's own rounding to bfloat16.
//
// Choices, from ptxas and first timings at q (4, 40, 4096, 128) causal on
// an H100: BK = 128 keys a tile with NS = 2 stages, 161 KB of shared memory
// a block.  64-key tiles (more barrier waits and softmax passes per key)
// were slower, and a third 128-key stage (225 KB) no faster.  Folding the
// scale into the exponent's FMA, with ex2.approx.ftz, made the largest
// difference: the softmax sits on the critical path while the two consumer
// warpgroups are not scheduled against each other.  ptxas: 168 registers
// at launch (the __launch_bounds__ cap for 384 threads, redistributed as
// 40 / 232 by setmaxnreg), no spills, at D 64 and 128.
//
// Head dim 112 (zamba2-7b) runs on the D 128 tile, padded.  The tensor maps
// keep the true inner extent, 112 columns (224-byte rows), so TMA fills
// columns 112-127 of the second 64-column box with zeros; the transaction
// count is the whole box either way.  S = Q K^T stops after 7 k-slices of
// 16 (the zero columns would add nothing), O += P V runs at N 128, and the
// epilogue stores 14 of the 16 column groups of 8.  The padding costs 1/8
// of the P V products and of the shared-memory traffic: at most 112/128 of
// the D 128 kernel's rate, which is fine for a first kernel at this D.

#include <cuda.h>           // CUtensorMap and its enums; the driver is reached
                            // through cudaGetDriverEntryPoint, not -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;        // query rows per block
constexpr int BK = 128;        // keys per tile
constexpr int NS = 2;          // K/V stages in the ring
constexpr int NT = 384;        // a producer and two consumer warpgroups
constexpr int COLS = 64;       // bf16 columns in one swizzled 128-byte row
constexpr int ROW_BYTES = 128;
constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Byte offsets in the block's shared memory, whose base is 1024-aligned (the
// 128-byte swizzle's atom is 8 rows of 128 bytes).  A tile of R rows is
// D / 64 boxes of R x 128 bytes, one after the other; D is the padded head
// dim (Padded<112> = 128).
template <int D>
struct Padded {
  static constexpr int value = (D + COLS - 1) / COLS * COLS;
};

template <int D>
struct Layout {
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;          // K or V of one stage
  static constexpr int K_OFF = Q_BYTES;                // + stage * KV_BYTES
  static constexpr int V_OFF = K_OFF + NS * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + NS * KV_BYTES;
  // barriers: Q full, NS x K/V full, NS x K/V empty; 8 bytes each
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * NS);
  static constexpr int ALLOC = BYTES + 1024;           // room to align
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of the 4-d map (D, S, H, B) at (d0, s0, h, b) into shared memory,
// completing `bytes` of `bar`'s transaction count
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d0, int s0, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(s0),
      "r"(h), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (in 16-byte units), layout 1 = 128-byte swizzle
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
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

// keep the compiler from moving reads or writes of an accumulator across the
// asynchronous wgmma's issue and wait
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 128, f32) {=, +=} A (64 x 16) * B (16 x 128), A and B bf16 in
// shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate)
      : "memory");
}

// d (64 x 128, f32) {=, +=} A (64 x 16) * B (16 x 128): A bf16 in registers,
// B bf16 in shared memory, MN-major (the instruction's transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4], uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate)
      : "memory");
}

// d (64 x 64, f32) {=, +=} A (64 x 16) * B (16 x 64): A bf16 in registers,
// B bf16 in shared memory, MN-major (the instruction's transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                           const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate)
      : "memory");
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 128)
    wgmma_rs_n128(o, a, b, 1);
  else
    wgmma_rs_n64(o, a, b, 1);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The accumulator fragment of a 64-row wgmma, as a thread of its warpgroup
// holds it: element 4 * j + e sits at row 16 * warp + lane / 4 (+ 8 when
// e >= 2) and column 8 * j + 2 * (lane % 4) + (e & 1).
template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             __nv_bfloat16* __restrict__ out, int hq,
                             int group, int sq, int skv, int causal,
                             int window, float scale_log2) {
  constexpr int DP = Padded<D>::value;         // the tile's columns
  using L = Layout<DP>;
  constexpr int CH = DP / COLS;                 // 64-column boxes in a row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_s = base, k_s = base + L::K_OFF, v_s = base + L::V_OFF;
  const uint32_t q_full = base + L::BAR_OFF;
  const uint32_t kv_full = q_full + 8, kv_empty = kv_full + 8 * NS;

  const int bh = blockIdx.x, b = bh / hq, h = bh % hq, hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest tiles first
  const int off = skv - sq;                          // q_pos = row + off

  // the key tiles this query tile needs (as in the SIMT kernel)
  const int first_pos = q0 + off;
  const int last_pos = min(q0 + BQ, sq) - 1 + off;
  int lo = 0, hi = (skv + BK - 1) / BK;
  if (!causal || first_pos >= 0) {
    // every row sees a key, so tiles that every row masks can be skipped
    if (causal) hi = min(hi, last_pos / BK + 1);
    if (window > 0) lo = max(0, first_pos - window + 1) / BK;
  }  // else rows before the first key average every key: visit them all
  const int n_tiles = hi - lo;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(kv_full + 8 * s, 1);
      mbar_init(kv_empty + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < CH; ++c)
        tma_load(q_s + c * BQ * ROW_BYTES, &tm_q, q_full, c * COLS, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % NS, k0 = (lo + i) * BK;
        mbar_wait(kv_empty + 8 * s, ((i / NS) & 1) ^ 1);
        mbar_expect_tx(kv_full + 8 * s, 2 * L::KV_BYTES);
        const uint32_t ks = k_s + s * L::KV_BYTES, vs = v_s + s * L::KV_BYTES;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          tma_load(ks + c * BK * ROW_BYTES, &tm_k, kv_full + 8 * s, c * COLS,
                   k0, hk, b);
          tma_load(vs + c * BK * ROW_BYTES, &tm_v, kv_full + 8 * s, c * COLS,
                   k0, hk, b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup 1 + wg owns query rows 64 * wg .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int t2 = 2 * (lane % 4);
  const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;   // and row0 + 8
  const int qp0 = row0 + off, qp1 = qp0 + 8;
  const int wg_first = q0 + 64 * wg + off;                 // first q_pos

  float s_acc[BK / 2];     // S: 64 x BK
  float o[DP / 2];         // O: 64 x DP (columns >= D stay 0)
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s_acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
  float m0 = MASKED, m1 = MASKED;   // running max of rows row0, row0 + 8
  float l0 = 0.0f, l1 = 0.0f;       // this thread's share of the denominator

  const uint32_t q_wg = q_s + 64 * wg * ROW_BYTES;
  mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % NS, k0 = (lo + i) * BK;
    const uint32_t ks = k_s + s * L::KV_BYTES, vs = v_s + s * L::KV_BYTES;
    mbar_wait(kv_full + 8 * s, (i / NS) & 1);

    // S = Q K^T over the true D in k-slices of 16 (D is a multiple of 16)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t step = (kk % 4) * 32 + (kk / 4) * BK * ROW_BYTES;
      const uint32_t qstep = (kk % 4) * 32 + (kk / 4) * BQ * ROW_BYTES;
      wgmma_ss_n128(s_acc, smem_desc(q_wg + qstep, 16, 1024),
                    smem_desc(ks + step, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(s_acc);

    // the online softmax in the log2 domain.  A tile needs the mask only
    // where it holds an absent key, a key past some row's causal bound, or
    // one before some row's window; there S is scaled, then masked.
    const bool edge = k0 + BK > skv || (causal && k0 + BK - 1 > wg_first) ||
                      (window > 0 && k0 <= wg_first + 63 - window) ||
                      scale_log2 < 0.0f;
    float mx0 = MASKED, mx1 = MASKED;
    if (edge) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s_acc[4 * j + e] * scale_log2;
          const int kp = k0 + 8 * j + t2 + (e & 1);
          const int qp = e < 2 ? qp0 : qp1;
          if (kp >= skv)
            x = -CUDART_INF_F;              // not a key: contributes nothing
          else if ((causal && kp > qp) || (window > 0 && kp <= qp - window))
            x = MASKED;
          s_acc[4 * j + e] = x;
          if (e < 2)
            mx0 = fmaxf(mx0, x);
          else
            mx1 = fmaxf(mx1, x);
        }
      }
    } else {
      // every score is a kept key: take the max of the raw scores, and
      // fold the scale into the exponent's FMA below
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s_acc[4 * j], s_acc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s_acc[4 * j + 2], s_acc[4 * j + 3]));
      }
      mx0 *= scale_log2;
      mx1 *= scale_log2;
    }
    const float c = edge ? 1.0f : scale_log2;
    const float n0 = fmaxf(m0, quad_max(mx0)), n1 = fmaxf(m1, quad_max(mx1));
    const float a0 = exp2f(m0 - n0), a1 = exp2f(m1 - n1);
    m0 = n0;
    m1 = n1;
    uint32_t p[BK / 4];      // P in bfloat16, two to a register
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) {
      const float nj = (j & 1) ? n1 : n0;
      const float x = exp2_ftz(fmaf(s_acc[2 * j], c, -nj));
      const float y = exp2_ftz(fmaf(s_acc[2 * j + 1], c, -nj));
      if (j & 1)
        sum1 += x + y;
      else
        sum0 += x + y;
      p[j] = pack_bf16(x, y);
    }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      o[4 * j] *= a0;
      o[4 * j + 1] *= a0;
      o[4 * j + 2] *= a1;
      o[4 * j + 3] *= a1;
    }

    // O += P V over the tile's keys in k-slices of 16
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                             p[4 * kk + 3]};
      wgmma_pv<DP>(o, a,
                  smem_desc(vs + kk * 16 * ROW_BYTES, BK * ROW_BYTES, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(o);
    mbar_arrive(kv_empty + 8 * s);
  }

  const float l_0 = quad_sum(l0), l_1 = quad_sum(l1);
  const float inv0 = 1.0f / (l_0 == 0.0f ? 1.0f : l_0);
  const float inv1 = 1.0f / (l_1 == 0.0f ? 1.0f : l_1);
  __nv_bfloat16* out0 = out + ((long long)bh * sq + row0) * D + t2;
  __nv_bfloat16* out1 = out0 + 8 * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {       // padded columns are not stored
    if (row0 < sq)
      *reinterpret_cast<__nv_bfloat162*>(out0 + 8 * j) =
          __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    if (row0 + 8 < sq)
      *reinterpret_cast<__nv_bfloat162*>(out1 + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// error codes of this library beyond CUDA's own
constexpr int ERR_NO_ENCODER = 10001;   // driver entry point not found
constexpr int ERR_ENCODE = 10002;       // cuTensorMapEncodeTiled refused

int encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess) return (int)e;
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return ERR_NO_ENCODER;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return 0;
}

// The 4-d map (D, S, H, B) of a (B, H, S, D) bfloat16 view with element
// strides st[0..2] over (batch, head, position), loaded in boxes of 64
// columns x `rows` positions under the 128-byte swizzle; rows past S, and
// columns past d in the last box (d 112), read as zeros.  A dimension of extent 1 gets the stride it would have if
// contiguous, since TMA wants every stride a nonzero multiple of 16 bytes.
int make_map(EncodeTiled encode, CUtensorMap* map, const void* base, int d,
             int s, int h, int b, const long long* st, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)h,
                              (cuuint64_t)b};
  cuuint64_t strides[3];
  strides[0] = s > 1 ? (cuuint64_t)st[2] * 2 : (cuuint64_t)d * 2;
  strides[1] = h > 1 ? (cuuint64_t)st[1] * 2 : strides[0] * s;
  strides[2] = b > 1 ? (cuuint64_t)st[0] * 2 : strides[1] * h;
  const cuuint32_t box[4] = {(cuuint32_t)COLS, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int hq, int hkv, int sq, int skv, const long long* st, int causal,
           int window, float scale, cudaStream_t stream) {
  EncodeTiled encode;
  int err = encoder(&encode);
  if (err) return err;
  CUtensorMap mq, mk, mv;
  if ((err = make_map(encode, &mq, q, D, sq, hq, b, st, BQ)) ||
      (err = make_map(encode, &mk, k, D, skv, hkv, b, st + 3, BK)) ||
      (err = make_map(encode, &mv, v, D, skv, hkv, b, st + 6, BK)))
    return err;
  constexpr int smem = Layout<Padded<D>::value>::ALLOC;
  // per device and cheap, so set on every launch
  const cudaError_t e = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(b * hq, (sq + BQ - 1) / BQ);
  flash_attention_wgmma_kernel<D><<<grid, NT, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), hq, hq / hkv, sq, skv,
      causal, window, scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns 0 or an error code; never synchronises
// and allocates nothing.  q, k, v and out are bfloat16; d is 64, 112 or
// 128.
// `strides` holds the element strides of q, k and v over (batch, head,
// position), in that order, nine in all; the last dimension is contiguous,
// every base address 16-byte aligned and every stride of an extent above 1
// a multiple of 8 elements.  `out` is (b, hq, sq, d) contiguous.  window <= 0
// means no window.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k,
                                            const void* v, void* out, int b,
                                            int hq, int hkv, int sq, int skv,
                                            int d, const long long* strides,
                                            int causal, int window,
                                            float scale, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (d == 64)
    return launch<64>(q, k, v, out, b, hq, hkv, sq, skv, strides, causal,
                      window, scale, stream);
  if (d == 112)
    return launch<112>(q, k, v, out, b, hq, hkv, sq, skv, strides, causal,
                       window, scale, stream);
  if (d == 128)
    return launch<128>(q, k, v, out, b, hq, hkv, sq, skv, strides, causal,
                       window, scale, stream);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory a block of the kernel for head dim d asks for.
extern "C" int flash_attention_wgmma_smem_bytes(int d) {
  return d == 64 ? Layout<64>::ALLOC
                 : (d == 112 || d == 128) ? Layout<128>::ALLOC : 0;
}

// Text of an error code, for the wrapper's exception.
extern "C" const char* flash_attention_wgmma_error_string(int code) {
  if (code == ERR_NO_ENCODER)
    return "the driver has no cuTensorMapEncodeTiled";
  if (code == ERR_ENCODE)
    return "cuTensorMapEncodeTiled refused a q/k/v layout";
  return cudaGetErrorString((cudaError_t)code);
}
