// Flash-attention backward for Hopper's tensor cores (sm_90a), bfloat16 at
// head dims 64, 112 and 128: the gradients dq, dk and dv of grouped-query
// attention with a causal mask aligned at the sequence ends and an optional
// sliding window, given q, k, v, the forward's output o, the output's
// gradient do and the forward's row statistics.
//
// The JAX package has no backward Pallas kernel: it trains through the
// plain jnp attention, so this kernel, the backward of `_fa_kernel`
// (src/repro/kernels/flash_attention/kernel.py:98) on the port's training
// path, is held against `jax.vjp` of that plain version through the port's
// plain backward (src/repro_torch/kernels/flash_attention/ref.py,
// `attention_bwd`) and autograd through `ref.attention`.  It is the
// backward of the tensor-core forward (csrc/flash_attention_wgmma.cu), whose
// route it shares; float32 and D 16/32 take the SIMT backward of
// csrc/flash_attention_bwd.cu.  Binding: src/repro_torch/kernels/
// flash_attention/kernel.py (ctypes).
//
// What it computes: the SIMT backward's function.  With S = scale q k^T,
// masked logits at the finite -1e30 of the forward (keys past Skv absent),
// the forward's row max m and sum l of exp(S - m), P = exp(S - m) / l and
// Di = rowsum(do * o):
//   dP = do v^T,  dS = P * (dP - Di), zeroed wherever the mask is false,
//   dq = scale dS k,  dk = scale dS^T q,  dv = P^T do,
// dk and dv summed over the query heads of each key/value head.  A row that
// sees no key (causal, before the first key when Sq > Skv) has P = 1/Skv
// on every key, as in the forward: it sends do/Skv to dv and gets dq = 0.
//
// What bounds it.  Five products of 2 D operations per visible (query, key)
// pair (S, dP, dq, dk, dv): 0.217 ms at q (2, 40, 2048, 128) causal at the
// H100's 989 TFLOP/s of dense bfloat16, against 0.13 GB of inputs and
// outputs (0.04 ms at 3.35 TB/s): bound by operations, so every product
// runs as wgmma with float32 accumulators.  This design does seven: S and
// dP are formed twice, once for dk/dv and once for dq, the price of needing
// no atomics and no cross-block ordering.
//
// Design, after FlashAttention-3's backward without its atomics, in three
// launches on one stream, each block owning its outputs, so the result is
// the same bits from run to run.
//   (a) `fa_bwd_pre`: Di, and the row statistics packed per 64-row tile as
//       m log2(e), 1/l and Di (768 bytes), rows past Sq zero; a small SIMT
//       pass over o and do.
//   (b) `fa_bwd_dkv_wgmma`: one block per (batch * key/value head, 128-key
//       tile), heaviest causal tiles first (blockIdx.y counts the key tiles
//       up, the tiles that most query rows reach).  Warpgroup 0 gives up
//       registers (setmaxnreg 40) and one of its threads loads K and V once
//       by TMA, then keeps a ring of NS = 2 stages full, each a 64-row
//       query tile of Q and do (TMA) and its packed statistics (a bulk
//       copy), for every query head of the group and every query tile that
//       reaches the key tile (a visible pair or a row that sees no key).
//       Warpgroups 1 and 2 (232 registers) own keys 0-63 and 64-127 and per
//       stage run
//         S^T = K Q^T, dP^T = V do^T   wgmma m64n64k16, A and B from shared
//                                      memory, both K-major;
//         P^T = exp2(scale log2(e) S^T - m log2(e)) / l, dS^T = P^T (dP^T -
//                                      Di), masked on tiles that need it;
//         dV += P^T do, dK += dS^T Q   wgmma m64nDk16, A = P^T or dS^T
//                                      rounded to bfloat16 in registers, B =
//                                      do or Q from shared memory, MN-major.
//       dK and dV stay in float32 registers across the whole group, so the
//       sum over its query heads needs no atomics; the epilogue writes
//       scale dK and dV as bfloat16.
//   (c) `fa_bwd_dq_wgmma`: one block per (batch * query head, 128-row query
//       tile), heaviest causal tiles first, laid out as the forward kernel:
//       Q and do loaded once, a ring of 64-key tiles of K and V over the
//       keys the rows see; per tile S = Q K^T and dP = do V^T (m64n64k16),
//       dS, then dQ += dS K (m64nDk16, K MN-major); dQ scaled and written
//       as bfloat16.
// Every tile is stored as 64-column boxes of 128-byte rows under TMA's
// 128-byte swizzle (hopper.cuh).  Head dim 112 runs on the 128-column tile
// with TMA zero-filling columns 112-127, as in the forward; the products
// over D stop after 7 k-slices and the epilogues store 14 column groups.
// Where it rounds, beside the plain backward's float32 arithmetic: P and dS
// are rounded to bfloat16 (unit roundoff 2^-8) as the A operands of the
// three products that take them, then each gradient once to bfloat16.
//
// `fault` plants one of two faults for chip_smoke.py's check that its
// limits catch them: 1 leaves dS unzeroed under the mask (P taken from the
// unmasked score), 2 leaves the group's last query head out of dK and dV.
// Every real call passes 0.

#include <math_constants.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int NT = 384;        // a producer and two consumer warpgroups
constexpr int NS = 2;          // stages in each ring
constexpr int TILE = 64;       // rows of a statistics tile
constexpr int STAT_FLOATS = 3 * TILE;          // m log2(e), 1/l, Di
constexpr int STAT_BYTES = STAT_FLOATS * 4;
// (b): keys a block (64 a consumer warpgroup) and query rows a stage
constexpr int KV_BK = 128;
constexpr int KV_BQ = 64;
// (c): query rows a block (64 a consumer warpgroup) and keys a stage
constexpr int DQ_BQ = 128;
constexpr int DQ_BK = 64;

constexpr int FAULT_MASK_NOT_ZEROED = 1;
constexpr int FAULT_HEAD_DROPPED = 2;

struct Mask {
  int sq, skv, off, causal, window;     // query row i sits at i + off

  __device__ __forceinline__ bool visible(int i, int k) const {
    const int p = i + off;
    return !(causal && k > p) && !(window > 0 && k <= p - window);
  }
  __device__ __forceinline__ bool keyless(int i) const {
    return causal && i + off < 0;
  }
  // rows [i0, i1] x keys [k0, k1] (ends not clamped) need the mask: an
  // absent row or key, or a pair the causal bound or the window hides
  __device__ __forceinline__ bool edge(int i0, int i1, int k0, int k1) const {
    return k1 >= skv || i1 >= sq || (causal && k1 > i0 + off) ||
           (window > 0 && k0 <= i1 + off - window);
  }
  // rows [i0, i1] x keys [k0, k1] move a gradient of k or v: a visible
  // pair, or a row that sees no key
  __device__ __forceinline__ bool live(int i0, int i1, int k0, int k1) const {
    if (causal && i0 + off < 0) return true;
    if (causal && k0 > i1 + off) return false;
    if (window > 0 && k1 <= i0 + off - window) return false;
    return true;
  }
};

// (a) Di = rowsum(do * o) and the statistics tiles, four threads a row, one
// block per (batch * query head, 64-row tile).  stats is the forward's
// float32 (2, B, Hq, Sq): m, then l.
template <int D>
__global__ void __launch_bounds__(256)
fa_bwd_pre(const __nv_bfloat16* __restrict__ o,
           const __nv_bfloat16* __restrict__ dout,
           const float* __restrict__ stats, float* __restrict__ packed,
           int hq, int sq, long long os0, long long os1, long long os2,
           long long ds0, long long ds1, long long ds2) {
  const int bh = blockIdx.x, b = bh / hq, h = bh % hq;
  const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
  const int row = blockIdx.y * TILE + r;
  float s = 0.0f;
  if (row < sq) {
    const __nv_bfloat16* orow = o + b * os0 + h * os1 + row * os2;
    const __nv_bfloat16* drow = dout + b * ds0 + h * ds1 + row * ds2;
    for (int c = part; c < D / 8; c += 4) {
      const uint4 a = *reinterpret_cast<const uint4*>(orow + 8 * c);
      const uint4 g = *reinterpret_cast<const uint4*>(drow + 8 * c);
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 fa = __bfloat1622float2(a2[j]);
        const float2 fg = __bfloat1622float2(g2[j]);
        s = fmaf(fa.x, fg.x, s);
        s = fmaf(fa.y, fg.y, s);
      }
    }
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  if (part == 0) {
    float* dst = packed + ((long long)bh * gridDim.y + blockIdx.y) * STAT_FLOATS;
    const long long n = (long long)gridDim.x * sq;
    const long long idx = (long long)bh * sq + row;
    const bool in = row < sq;
    dst[r] = in ? stats[idx] * LOG2E : 0.0f;
    dst[TILE + r] = in ? 1.0f / stats[n + idx] : 0.0f;
    dst[2 * TILE + r] = in ? s : 0.0f;
  }
}

// (b)'s shared memory: K and V of the block, then NS stages of Q, do and
// the statistics tile; base 1024-aligned, every tile a run of 64-column
// boxes.  DP is the padded head dim.
template <int DP>
struct KvLayout {
  static constexpr int K_BYTES = KV_BK * DP * 2;       // K, and V
  static constexpr int Q_BYTES = KV_BQ * DP * 2;       // Q, and do, a stage
  static constexpr int STAGE = 2 * Q_BYTES + 1024;     // Q, do, statistics
  static constexpr int V_OFF = K_BYTES;
  static constexpr int STAGE_OFF = 2 * K_BYTES;
  static constexpr int BAR_OFF = STAGE_OFF + NS * STAGE;
  // barriers: K/V full, NS x stage full, NS x stage empty
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * NS);
  static constexpr int ALLOC = BYTES + 1024;           // room to align
};

template <int D>
__global__ void __launch_bounds__(NT, 1)
fa_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_do,
                 const float* __restrict__ packed,
                 __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv, int hq, int hkv, int sq,
                 int skv, int causal, int window, float scale,
                 float scale_log2, int fault) {
  constexpr int DP = Padded<D>::value, CH = DP / COLS;
  using L = KvLayout<DP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint8_t* gbase = smem_raw + (base - raw);     // generic address
  const uint32_t k_s = base, v_s = base + L::V_OFF;
  const uint32_t kv_full = base + L::BAR_OFF;
  const uint32_t full = kv_full + 8, empty = full + 8 * NS;

  const int bh = blockIdx.x, b = bh / hkv, hk = bh % hkv;
  const int group = hq / hkv;
  const int k0 = blockIdx.y * KV_BK, k1 = min(k0 + KV_BK, skv) - 1;
  const int n_qt = (sq + KV_BQ - 1) / KV_BQ;
  const Mask M{sq, skv, skv - sq, causal, window};
  const int heads = fault == FAULT_HEAD_DROPPED ? group - 1 : group;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread loads K and V, then keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * L::K_BYTES);
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        tma_load(k_s + c * KV_BK * ROW_BYTES, &tm_k, kv_full, c * COLS, k0, hk,
                 b);
        tma_load(v_s + c * KV_BK * ROW_BYTES, &tm_v, kv_full, c * COLS, k0, hk,
                 b);
      }
      int i = 0;
      for (int g = 0; g < heads; ++g) {
        const int h = hk * group + g;
        for (int t = 0; t < n_qt; ++t) {
          const int q0 = t * KV_BQ;
          if (!M.live(q0, min(q0 + KV_BQ, sq) - 1, k0, k1)) continue;
          const int s = i % NS;
          mbar_wait(empty + 8 * s, ((i / NS) & 1) ^ 1);
          const uint32_t st = base + L::STAGE_OFF + s * L::STAGE;
          mbar_expect_tx(full + 8 * s, 2 * L::Q_BYTES + STAT_BYTES);
#pragma unroll
          for (int c = 0; c < CH; ++c) {
            tma_load(st + c * KV_BQ * ROW_BYTES, &tm_q, full + 8 * s,
                     c * COLS, q0, h, b);
            tma_load(st + L::Q_BYTES + c * KV_BQ * ROW_BYTES, &tm_do,
                     full + 8 * s, c * COLS, q0, h, b);
          }
          bulk_load(st + 2 * L::Q_BYTES,
                    packed + ((long long)(b * hq + h) * n_qt + t) * STAT_FLOATS,
                    STAT_BYTES, full + 8 * s);
          ++i;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup 1 + wg owns keys k0 + 64 * wg .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int t2 = 2 * (lane % 4);
  const int kw0 = k0 + 64 * wg;                     // the warpgroup's keys
  const int kr = kw0 + 16 * warp + lane / 4;        // and kr + 8
  const uint32_t k_wg = k_s + 64 * wg * ROW_BYTES;
  const uint32_t v_wg = v_s + 64 * wg * ROW_BYTES;

  float dk_acc[DP / 2], dv_acc[DP / 2];   // 64 keys x DP (columns >= D: 0)
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) {
    dk_acc[i] = 0.0f;
    dv_acc[i] = 0.0f;
  }
  float s_acc[32], dp_acc[32];           // S^T and dP^T: 64 keys x 64 rows

  mbar_wait(kv_full, 0);
  int i = 0;
  for (int g = 0; g < heads; ++g) {
    for (int t = 0; t < n_qt; ++t) {
      const int q0 = t * KV_BQ;
      if (!M.live(q0, min(q0 + KV_BQ, sq) - 1, k0, k1)) continue;
      const int s = i % NS;
      const uint32_t qs = base + L::STAGE_OFF + s * L::STAGE;
      const uint32_t ds = qs + L::Q_BYTES;
      const float* stat = reinterpret_cast<const float*>(
          gbase + L::STAGE_OFF + s * L::STAGE + 2 * L::Q_BYTES);
      mbar_wait(full + 8 * s, (i / NS) & 1);

      // S^T = K Q^T and dP^T = V do^T over the true D in k-slices of 16.
      // The accumulators start from zeros written here, so their last
      // values are dead and hold no registers through the products below.
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        s_acc[j] = 0.0f;
        dp_acc[j] = 0.0f;
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t ka = (kk % 4) * 32 + (kk / 4) * KV_BK * ROW_BYTES;
        const uint32_t qa = (kk % 4) * 32 + (kk / 4) * KV_BQ * ROW_BYTES;
        wgmma_ss_n64(s_acc, smem_desc(k_wg + ka, 16, 1024),
                     smem_desc(qs + qa, 16, 1024), 1);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t ka = (kk % 4) * 32 + (kk / 4) * KV_BK * ROW_BYTES;
        const uint32_t qa = (kk % 4) * 32 + (kk / 4) * KV_BQ * ROW_BYTES;
        wgmma_ss_n64(dp_acc, smem_desc(v_wg + ka, 16, 1024),
                     smem_desc(ds + qa, 16, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(s_acc);
      pin(dp_acc);

      // P^T and dS^T, rounded to bfloat16 two to a register.  Column c of
      // the fragment is query row q0 + c, whose statistics sit at stat[c].
      const bool edge = M.edge(q0, q0 + KV_BQ - 1, kw0, kw0 + 63);
      uint32_t pa[16], da[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 m2 = *reinterpret_cast<const float2*>(stat + 8 * j + t2);
        const float2 il =
            *reinterpret_cast<const float2*>(stat + TILE + 8 * j + t2);
        const float2 di =
            *reinterpret_cast<const float2*>(stat + 2 * TILE + 8 * j + t2);
        float p[4], d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float mm = (e & 1) ? m2.y : m2.x;
          const float ll = (e & 1) ? il.y : il.x;
          const float dd = (e & 1) ? di.y : di.x;
          float pv = exp2_ftz(fmaf(s_acc[4 * j + e], scale_log2, -mm)) * ll;
          float dsv = pv * (dp_acc[4 * j + e] - dd);
          if (edge) {
            const int qi = q0 + 8 * j + t2 + (e & 1);
            const int kj = kr + (e >= 2 ? 8 : 0);
            if (kj >= skv || qi >= sq) {
              pv = 0.0f;                   // not a key, or not a row
              dsv = 0.0f;
            } else if (!M.visible(qi, kj)) {
              pv = M.keyless(qi) ? ll : 0.0f;
              if (fault != FAULT_MASK_NOT_ZEROED) dsv = 0.0f;
            }
          }
          p[e] = pv;
          d[e] = dsv;
        }
        pa[2 * j] = pack_bf16(p[0], p[1]);
        pa[2 * j + 1] = pack_bf16(p[2], p[3]);
        da[2 * j] = pack_bf16(d[0], d[1]);
        da[2 * j + 1] = pack_bf16(d[2], d[3]);
      }

      // dV += P^T do and dK += dS^T Q over the stage's 64 rows in k-slices
      // of 16: B MN-major (leading byte offset = the next 64 columns of D,
      // stride byte offset = the next 8 rows)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KV_BQ / 16; ++kk) {
        const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                               pa[4 * kk + 3]};
        wgmma_rs<DP>(dv_acc, a,
                     smem_desc(ds + kk * 16 * ROW_BYTES, KV_BQ * ROW_BYTES,
                               1024));
        const uint32_t a2[4] = {da[4 * kk], da[4 * kk + 1], da[4 * kk + 2],
                                da[4 * kk + 3]};
        wgmma_rs<DP>(dk_acc, a2,
                     smem_desc(qs + kk * 16 * ROW_BYTES, KV_BQ * ROW_BYTES,
                               1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(dv_acc);
      pin(dk_acc);
      mbar_arrive(empty + 8 * s);
      ++i;
    }
  }

  __nv_bfloat16* dk0 = dk + ((long long)bh * skv + kr) * D + t2;
  __nv_bfloat16* dv0 = dv + ((long long)bh * skv + kr) * D + t2;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {       // padded columns are not stored
    if (kr < skv) {
      *reinterpret_cast<__nv_bfloat162*>(dk0 + 8 * j) = __floats2bfloat162_rn(
          dk_acc[4 * j] * scale, dk_acc[4 * j + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv0 + 8 * j) =
          __floats2bfloat162_rn(dv_acc[4 * j], dv_acc[4 * j + 1]);
    }
    if (kr + 8 < skv) {
      *reinterpret_cast<__nv_bfloat162*>(dk0 + 8 * D + 8 * j) =
          __floats2bfloat162_rn(dk_acc[4 * j + 2] * scale,
                                dk_acc[4 * j + 3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv0 + 8 * D + 8 * j) =
          __floats2bfloat162_rn(dv_acc[4 * j + 2], dv_acc[4 * j + 3]);
    }
  }
}

// (c)'s shared memory: Q and do of the block, then NS stages of K and V.
template <int DP>
struct DqLayout {
  static constexpr int Q_BYTES = DQ_BQ * DP * 2;       // Q, and do
  static constexpr int K_BYTES = DQ_BK * DP * 2;       // K, and V, a stage
  static constexpr int DO_OFF = Q_BYTES;
  static constexpr int STAGE_OFF = 2 * Q_BYTES;
  static constexpr int STAGE = 2 * K_BYTES;
  static constexpr int BAR_OFF = STAGE_OFF + NS * STAGE;
  // barriers: Q/do full, NS x stage full, NS x stage empty
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * NS);
  static constexpr int ALLOC = BYTES + 1024;           // room to align
};

template <int D>
__global__ void __launch_bounds__(NT, 1)
fa_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_do,
                const float* __restrict__ packed,
                __nv_bfloat16* __restrict__ dq, int hq, int hkv, int sq,
                int skv, int causal, int window, float scale,
                float scale_log2, int fault) {
  constexpr int DP = Padded<D>::value, CH = DP / COLS;
  using L = DqLayout<DP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base, do_s = base + L::DO_OFF;
  const uint32_t q_full = base + L::BAR_OFF;
  const uint32_t full = q_full + 8, empty = full + 8 * NS;

  const int bh = blockIdx.x, b = bh / hq, h = bh % hq, hk = h / (hq / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * DQ_BQ;   // heaviest first
  const Mask M{sq, skv, skv - sq, causal, window};

  // the key tiles holding a pair some row sees (rows that see no key get
  // dq = 0 and need none)
  const int first_pos = q0 + M.off;
  const int last_pos = min(q0 + DQ_BQ, sq) - 1 + M.off;
  int lo = 0, hi = (skv + DQ_BK - 1) / DQ_BK;
  if (causal) hi = last_pos < 0 ? 0 : min(hi, last_pos / DQ_BK + 1);
  if (window > 0) lo = max(0, first_pos - window + 1) / DQ_BK;
  const int n_tiles = max(0, hi - lo);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread loads Q and do, then keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        tma_load(q_s + c * DQ_BQ * ROW_BYTES, &tm_q, q_full, c * COLS, q0, h,
                 b);
        tma_load(do_s + c * DQ_BQ * ROW_BYTES, &tm_do, q_full, c * COLS, q0,
                 h, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % NS, k0 = (lo + i) * DQ_BK;
        mbar_wait(empty + 8 * s, ((i / NS) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * L::K_BYTES);
        const uint32_t ks = base + L::STAGE_OFF + s * L::STAGE;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          tma_load(ks + c * DQ_BK * ROW_BYTES, &tm_k, full + 8 * s, c * COLS,
                   k0, hk, b);
          tma_load(ks + L::K_BYTES + c * DQ_BK * ROW_BYTES, &tm_v,
                   full + 8 * s, c * COLS, k0, hk, b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup 1 + wg owns query rows q0 + 64 * wg .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int t2 = 2 * (lane % 4);
  const int qw0 = q0 + 64 * wg;
  const int r0 = qw0 + 16 * warp + lane / 4, r1 = r0 + 8;
  // the two rows' statistics
  const int n_qt = (sq + TILE - 1) / TILE;
  float m2[2], il[2], di[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int r = x ? r1 : r0;
    const float* st =
        packed + ((long long)bh * n_qt + r / TILE) * STAT_FLOATS + r % TILE;
    const bool in = r < sq;
    m2[x] = in ? st[0] : 0.0f;
    il[x] = in ? st[TILE] : 0.0f;
    di[x] = in ? st[2 * TILE] : 0.0f;
  }
  const uint32_t q_wg = q_s + 64 * wg * ROW_BYTES;
  const uint32_t do_wg = do_s + 64 * wg * ROW_BYTES;

  float dq_acc[DP / 2];        // 64 rows x DP (columns >= D stay 0)
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq_acc[i] = 0.0f;
  float s_acc[32], dp_acc[32];

  mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % NS, k0 = (lo + i) * DQ_BK;
    const uint32_t ks = base + L::STAGE_OFF + s * L::STAGE;
    const uint32_t vs = ks + L::K_BYTES;
    mbar_wait(full + 8 * s, (i / NS) & 1);

    // S = Q K^T and dP = do V^T over the true D in k-slices of 16
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      s_acc[j] = 0.0f;
      dp_acc[j] = 0.0f;
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t qa = (kk % 4) * 32 + (kk / 4) * DQ_BQ * ROW_BYTES;
      const uint32_t ka = (kk % 4) * 32 + (kk / 4) * DQ_BK * ROW_BYTES;
      wgmma_ss_n64(s_acc, smem_desc(q_wg + qa, 16, 1024),
                   smem_desc(ks + ka, 16, 1024), 1);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t qa = (kk % 4) * 32 + (kk / 4) * DQ_BQ * ROW_BYTES;
      const uint32_t ka = (kk % 4) * 32 + (kk / 4) * DQ_BK * ROW_BYTES;
      wgmma_ss_n64(dp_acc, smem_desc(do_wg + qa, 16, 1024),
                   smem_desc(vs + ka, 16, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(s_acc);
    pin(dp_acc);

    // dS in bfloat16, two to a register; zero under the mask
    const bool edge = M.edge(qw0, qw0 + 63, k0, k0 + DQ_BK - 1);
    uint32_t da[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = e >> 1;
        const float p =
            exp2_ftz(fmaf(s_acc[4 * j + e], scale_log2, -m2[x])) * il[x];
        float dsv = p * (dp_acc[4 * j + e] - di[x]);
        if (edge) {
          const int row = x ? r1 : r0;
          const int key = k0 + 8 * j + t2 + (e & 1);
          const bool real = key < skv && row < sq;
          if (!real || (!M.visible(row, key) &&
                        fault != FAULT_MASK_NOT_ZEROED))
            dsv = 0.0f;
        }
        d[e] = dsv;
      }
      da[2 * j] = pack_bf16(d[0], d[1]);
      da[2 * j + 1] = pack_bf16(d[2], d[3]);
    }

    // dQ += dS K over the tile's 64 keys in k-slices of 16, K MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQ_BK / 16; ++kk) {
      const uint32_t a[4] = {da[4 * kk], da[4 * kk + 1], da[4 * kk + 2],
                             da[4 * kk + 3]};
      wgmma_rs<DP>(dq_acc, a,
                   smem_desc(ks + kk * 16 * ROW_BYTES, DQ_BK * ROW_BYTES,
                             1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(dq_acc);
    mbar_arrive(empty + 8 * s);
  }

  __nv_bfloat16* out0 = dq + ((long long)bh * sq + r0) * D + t2;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {       // padded columns are not stored
    if (r0 < sq)
      *reinterpret_cast<__nv_bfloat162*>(out0 + 8 * j) = __floats2bfloat162_rn(
          dq_acc[4 * j] * scale, dq_acc[4 * j + 1] * scale);
    if (r1 < sq)
      *reinterpret_cast<__nv_bfloat162*>(out0 + 8 * D + 8 * j) =
          __floats2bfloat162_rn(dq_acc[4 * j + 2] * scale,
                                dq_acc[4 * j + 3] * scale);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv,
           const float* stats, float* packed, int b, int hq, int hkv, int sq,
           int skv, const long long* st, int causal, int window, float scale,
           int fault, cudaStream_t stream) {
  constexpr int DP = Padded<D>::value;
  EncodeTiled encode;
  int err = encoder(&encode);
  if (err) return err;
  // (b) reads 64-row tiles of q and do and 128-row tiles of k and v, (c)
  // the other way round
  CUtensorMap bq, bk, bv, bdo, cq, ck, cv, cdo;
  if ((err = make_map(encode, &bq, q, D, sq, hq, b, st, KV_BQ)) ||
      (err = make_map(encode, &bk, k, D, skv, hkv, b, st + 3, KV_BK)) ||
      (err = make_map(encode, &bv, v, D, skv, hkv, b, st + 6, KV_BK)) ||
      (err = make_map(encode, &bdo, dout, D, sq, hq, b, st + 12, KV_BQ)) ||
      (err = make_map(encode, &cq, q, D, sq, hq, b, st, DQ_BQ)) ||
      (err = make_map(encode, &ck, k, D, skv, hkv, b, st + 3, DQ_BK)) ||
      (err = make_map(encode, &cv, v, D, skv, hkv, b, st + 6, DQ_BK)) ||
      (err = make_map(encode, &cdo, dout, D, sq, hq, b, st + 12, DQ_BQ)))
    return err;
  constexpr int kv_smem = KvLayout<DP>::ALLOC, dq_smem = DqLayout<DP>::ALLOC;
  // per device and cheap, so set on every launch
  cudaError_t e = cudaFuncSetAttribute(
      fa_bwd_dkv_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kv_smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(fa_bwd_dq_wgmma<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           dq_smem);
  if (e != cudaSuccess) return (int)e;
  const __nv_bfloat16* ob = static_cast<const __nv_bfloat16*>(o);
  const __nv_bfloat16* db = static_cast<const __nv_bfloat16*>(dout);
  fa_bwd_pre<D><<<dim3(b * hq, (sq + TILE - 1) / TILE), 256, 0, stream>>>(
      ob, db, stats, packed, hq, sq, st[9], st[10], st[11], st[12], st[13],
      st[14]);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const float scale_log2 = scale * LOG2E;
  fa_bwd_dkv_wgmma<D><<<dim3(b * hkv, (skv + KV_BK - 1) / KV_BK), NT,
                        kv_smem, stream>>>(
      bq, bk, bv, bdo, packed, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), hq, hkv, sq, skv, causal, window,
      scale, scale_log2, fault);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  fa_bwd_dq_wgmma<D><<<dim3(b * hq, (sq + DQ_BQ - 1) / DQ_BQ), NT, dq_smem,
                       stream>>>(
      cq, ck, cv, cdo, packed, static_cast<__nv_bfloat16*>(dq), hq, hkv, sq,
      skv, causal, window, scale, scale_log2, fault);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the three kernels on `stream` and returns 0 or an error code;
// never synchronises and allocates nothing.  q, k, v, o, do, dq, dk and dv
// are bfloat16; d is 64, 112 or 128.  `strides` holds the element strides
// over (batch, head, position) of q, k, v, o and do, in that order, fifteen
// in all; each last dimension is contiguous, every base address 16-byte
// aligned and every stride of an extent above 1 a multiple of 8 elements.
// dq is (b, hq, sq, d), dk and dv (b, hkv, skv, d), contiguous.  `stats` is
// the forward's float32 (2, b, hq, sq) of each row's m and l; `packed` is
// float32 scratch of b * hq * ceil(sq / 64) * 192, 16-byte aligned.
// window <= 0 means no window; `fault` is 0 but in chip_smoke.py's planted
// faults.
extern "C" int flash_attention_bwd_wgmma_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, const void* stats,
    void* packed, int b, int hq, int hkv, int sq, int skv, int d,
    const long long* strides, int causal, int window, float scale, int fault,
    void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const float* st = static_cast<const float*>(stats);
  float* pk = static_cast<float*>(packed);
  if (d == 64)
    return launch<64>(q, k, v, o, dout, dq, dk, dv, st, pk, b, hq, hkv, sq,
                      skv, strides, causal, window, scale, fault, stream);
  if (d == 112)
    return launch<112>(q, k, v, o, dout, dq, dk, dv, st, pk, b, hq, hkv, sq,
                       skv, strides, causal, window, scale, fault, stream);
  if (d == 128)
    return launch<128>(q, k, v, o, dout, dq, dk, dv, st, pk, b, hq, hkv, sq,
                       skv, strides, causal, window, scale, fault, stream);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory a block of (b) (`which` 0) or (c) (1) asks for at
// head dim d.
extern "C" int flash_attention_bwd_wgmma_smem_bytes(int d, int which) {
  if (d == 64) return which ? DqLayout<64>::ALLOC : KvLayout<64>::ALLOC;
  if (d == 112 || d == 128)
    return which ? DqLayout<128>::ALLOC : KvLayout<128>::ALLOC;
  return 0;
}

// Text of an error code, for the wrapper's exception.
extern "C" const char* flash_attention_bwd_wgmma_error_string(int code) {
  return hopper::error_string(code);
}
