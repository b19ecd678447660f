// Flash-attention backward for Hopper (sm_90a), the SIMT route: the
// gradients dq, dk and dv of grouped-query attention with a causal mask
// aligned at the sequence ends and an optional sliding window, given q, k,
// v, the forward's output o, the output's gradient do and the forward's row
// statistics, in float32 FMAs outside the tensor cores, for float32 and for
// bfloat16 at head dims 16 and 32.
//
// The JAX package has no backward Pallas kernel: it trains through the
// plain jnp attention (`repro/models/transformer.py`, attn_impl="ref"), so
// this kernel is held against `jax.vjp` of that plain version and against
// autograd through the port's plain version
// (src/repro_torch/kernels/flash_attention/ref.py, whose `attention_bwd` is
// the same algorithm).  It is the backward of the SIMT forward
// (csrc/flash_attention.cu), whose route it shares.  Binding and launch
// plans (`simt_plan`): src/repro_torch/kernels/flash_attention/kernel.py
// (ctypes).
//
// What it computes.  With S = scale q k^T, masked logits set to the finite
// -1e30 of the forward (keys past Skv absent), P = softmax(S) by row, and
// Di = rowsum(do * o):
//   dP = do v^T,  dS = P * (dP - Di), zeroed wherever the mask is false,
//   dq = scale dS k,  dk = scale dS^T q,  dv = P^T do.
// dS is zeroed at masked scores because that is the gradient of the plain
// version's `where`; P is not relied on to be 0 there.  A row that sees no
// key (a causal row before the first key when Sq > Skv) has P = 1/Skv on
// every key, as in the forward, so dv receives do/Skv from it and its dq is
// 0.  The row statistics, the max m and the sum l of exp(S - m) of each row,
// come from the forward (csrc/flash_attention.cu writes them when asked),
// kept apart (not m + log l, which rounds to m for a row whose scores are
// all -1e30).
//
// What bounds it.  Seven products of 2 D operations per visible (query, key)
// pair (S, dP and dq in the dq launch; S, dP, dk and dv in the dk/dv launch;
// the bound counts five) against a few bytes per element of q, k, v, o and
// do: bound by operations, here full IEEE float32 FMAs (67 TFLOP/s at most;
// no TF32).  bfloat16 at D 64, 112 and 128 takes the tensor-core backward of
// csrc/flash_attention_bwd_wgmma.cu.
//
// Design (Hopper).  Two launches, each block owning its
// outputs, so no atomics and the result is bit-equal run to run.  Each
// keeps one operand pair resident (read once through registers, widened)
// and streams the other by cp.async, a tile in flight while the block
// works (bfloat16 lands raw and is widened once by the block).  The
// products are register tiles whose every float read from shared memory
// feeds 4 to 16 FMAs; dS and P pass between the two products of a launch
// through shared memory, padded or swizzled so that neither side
// conflicts.
//   - `fa_bwd_dq`, one block per (batch * query head, query tile), every
//     head's heaviest causal tiles first: Di (written for the second
//     launch), then one pass over the key tiles through a two-stage ring
//     of (K, V): S and dP as 4-row x (BK/16)-key tiles (keys tx + 16 j),
//     dS from the forward's statistics, dq += dS k as 4 rows x D/16
//     columns.  Q (scaled) and do resident in [D/4][BQ][4]; K and V in
//     padded rows (read by key and by row).  Two barriers a tile.
//   - `fa_bwd_dkv`, one block per (batch * key/value head, 64 keys), key
//     tile 0 first: for each query head of the group and each BQ-row
//     step that reaches the keys, dP^T = V do^T, then S^T = K q^T, as
//     4-key (2 below D 64) x (BQ/8)-row tiles over eight lanes, P and dS
//     from the statistics (read into registers ahead of the products),
//     then dv += P^T do and dk += dS^T q as 16 keys (8, 4) x one column
//     vector a thread, summing the group's heads in registers.  K and V
//     resident in [D/4][64][4]; q and do in one slot each (rows swizzled,
//     or padded at D 16 and 112), alternating: do of the next step lands
//     while the block forms dk, q while it forms dP^T.  Four barriers a
//     step.
// A tile pair is visited only when it holds a visible pair or a row that
// sees no key, and only tiles that straddle a mask edge or an end test
// the mask.  Shared memory at D 128: 108,672 bytes (dq) and 114,688
// (dk/dv), two blocks an SM each (`simt_plan`).  q, k, v, o and do are read
// at their strides (the heads views of the model's projections; do arrives
// as one); dq, dk and dv are contiguous.
//
// `fault` plants one of two faults for chip_smoke.py's check that the
// route's limit catches them (kernel.py's BWD_FAULTS, the tensor-core
// backward's codes): 1 leaves dS unzeroed under the mask (P taken from the
// unmasked score), 2 leaves the group's last query head out of dK and dV.
// Every real call passes 0.

#include "flash_attention_simt.cuh"

namespace {

using namespace simt;

constexpr int TX = 16;      // dq: lanes that share a run of 4 rows
constexpr int FAULT_MASK_NOT_ZEROED = 1;
constexpr int FAULT_HEAD_DROPPED = 2;

struct Attn {
  int hq, hkv, group, sq, skv, causal, window;
  float scale;
  // element strides over (batch, head, position) of q, k, v, o and do
  long long qs[3], ks[3], vs[3], os[3], ds[3];

  __device__ __forceinline__ int off() const { return skv - sq; }

  // key k seen by query row i (both in range)
  __device__ __forceinline__ bool visible(int i, int k) const {
    const int q_pos = i + skv - sq;
    return !(causal && k > q_pos) && !(window > 0 && k <= q_pos - window);
  }

  // rows [i0, i1] x keys [k0, k1] hold a pair that moves a gradient: a
  // visible pair, or a row that sees no key (P = 1/Skv on every key)
  __device__ __forceinline__ bool tile_live(int i0, int i1, int k0,
                                            int k1) const {
    const int o = off();
    if (causal && i0 + o < 0) return true;
    if (causal && k0 > i1 + o) return false;
    if (window > 0 && k1 <= i0 + o - window) return false;
    return true;
  }

  // rows [i0, i0 + bq) x keys [k0, k0 + bk) are all real and all visible
  __device__ __forceinline__ bool all_visible(int i0, int bq, int k0,
                                              int bk) const {
    const int o = off();
    return k0 + bk <= skv && i0 + bq <= sq &&
           (!causal || k0 + bk - 1 <= i0 + o) &&
           (window <= 0 || k0 > i0 + bq - 1 + o - window);
  }
};

// the launch plans of each head dim (MINB: blocks an SM, capped lower where
// shared memory holds fewer); kernel.py's simt_plan states the same
template <int D> struct Plan;
template <> struct Plan<128> {
  static constexpr int BQ = 32, BK = 64, VW = 4, MINB = 2;
};
template <> struct Plan<112> {
  static constexpr int BQ = 32, BK = 64, VW = 4, MINB = 2;
};
template <> struct Plan<64> {
  static constexpr int BQ = 32, BK = 64, VW = 4, MINB = 2;
};
template <> struct Plan<32> {
  static constexpr int BQ = 64, BK = 64, VW = 2, MINB = 2;
};
template <> struct Plan<16> {
  static constexpr int BQ = 64, BK = 64, VW = 1, MINB = 2;
};

template <int SMEM, int CAP>
struct Resident {
  static constexpr int FIT = SM_SMEM / (SMEM + BLOCK_RESERVED);
  static constexpr int VALUE = FIT < CAP ? FIT : CAP;
};

// ---- dq: per (batch * query head, BQ query rows), BK keys a tile
template <typename T, int D>
struct DqShape {
  using C = Plan<D>;
  static constexpr int BQ = C::BQ, BK = C::BK, VW = C::VW;
  static constexpr int TY = BQ / 4, NT = TY * TX;   // 4 rows a thread
  static constexpr int NU = D / 4, CK = BK / TX, NCV = D / VW;
  static constexpr int CPT = (NCV + TX - 1) / TX;
  static constexpr int SP = BQ + 4;                 // dS^T row pitch
  static constexpr bool RAW = sizeof(T) == 2;
  using QL = UnitMajor<D, BQ>;
  using KL = PaddedRows<D, BK>;
  using VL = UnitMajor<D, BK>;
  static constexpr int SMEM =
      (2 * QL::FLOATS + BK * SP + BQ + KL::FLOATS + VL::FLOATS) * 4 +
      (RAW ? 2 * BK * D * (int)sizeof(T) : 0);
  static constexpr int MINB = Resident<SMEM, C::MINB>::VALUE;
  static_assert(NT / BQ == 4, "four threads a row for Di");
};

template <typename T, int D>
__global__ void __launch_bounds__(DqShape<T, D>::NT, DqShape<T, D>::MINB)
fa_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ o,
          const T* __restrict__ dout, T* __restrict__ dq,
          const float* __restrict__ stats, float* __restrict__ di_out,
          Attn A, int fault) {
  using S = DqShape<T, D>;
  constexpr int BQ = S::BQ, BK = S::BK, NT = S::NT, VW = S::VW;
  constexpr int NU = S::NU, CK = S::CK, NCV = S::NCV, CPT = S::CPT;
  constexpr int SP = S::SP;
  using QL = typename S::QL;
  using KL = typename S::KL;
  using VL = typename S::VL;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                       // [NU][BQ][4], scaled
  float* dOs = Qs + QL::FLOATS;           // [NU][BQ][4]
  float* dSt = dOs + QL::FLOATS;          // [BK][SP]: dS transposed
  float* Ds = dSt + BK * SP;              // [BQ]: Di
  float* Ks = Ds + BQ;                    // the K slot, padded rows
  float* Vs = Ks + KL::FLOATS;            // the V slot, [NU][BK][4]
  T* Kraw = reinterpret_cast<T*>(Vs + VL::FLOATS);   // bfloat16: [BK][D]
  T* Vraw = Kraw + BK * D;

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;   // heaviest tiles first
  const int b = bh / A.hq, h = bh % A.hq, hk = h / A.group;
  const int q0 = qt * BQ, i1 = min(q0 + BQ, A.sq) - 1;
  const int off = A.off();
  const T* qb = q + b * A.qs[0] + h * A.qs[1];
  const T* ob = o + b * A.os[0] + h * A.os[1];
  const T* db = dout + b * A.ds[0] + h * A.ds[1];
  const T* kb = k + b * A.ks[0] + hk * A.ks[1];
  const T* vb = v + b * A.vs[0] + hk * A.vs[1];

  // the key tiles this query tile needs (Attn::tile_live, as a range)
  const int first_pos = q0 + off, last_pos = i1 + off;
  int lo = 0, hi = (A.skv + BK - 1) / BK;
  if (!A.causal || first_pos >= 0) {
    if (A.causal) hi = min(hi, last_pos / BK + 1);
    if (A.window > 0) lo = max(0, first_pos - A.window + 1) / BK;
  }

  // K and V of tile t into their slots (float32 straight into their
  // layouts, bfloat16 raw)
  auto issue_k = [&](int t) {
    if constexpr (S::RAW)
      issue_rows<T, D, BK, NT, KL>(Kraw, kb, A.ks[2], t * BK, A.skv);
    else
      issue_rows<T, D, BK, NT, KL>(Ks, kb, A.ks[2], t * BK, A.skv);
    cp_commit();
  };
  auto issue_v = [&](int t) {
    if constexpr (S::RAW)
      issue_rows<T, D, BK, NT, VL>(Vraw, vb, A.vs[2], t * BK, A.skv);
    else
      issue_rows<T, D, BK, NT, VL>(Vs, vb, A.vs[2], t * BK, A.skv);
    cp_commit();
  };

  if (lo < hi) issue_v(lo);
  load_rows<T, D, BQ, NT, QL>(Qs, qb, A.qs[2], q0, A.sq, A.scale);
  load_rows<T, D, BQ, NT, QL>(dOs, db, A.ds[2], q0, A.sq, 1.0f);
  {  // Di = rowsum(do * o), four threads a row
    constexpr int VEC = 16 / sizeof(T), CH = D / VEC;
    const int r = tid >> 2, part = tid & 3;
    float s = 0.0f;
    if (q0 + r < A.sq)
      for (int c = part; c < CH; c += 4) {
        const Pack<T, VEC> po = *reinterpret_cast<const Pack<T, VEC>*>(
            ob + (long long)(q0 + r) * A.os[2] + c * VEC);
        const Pack<T, VEC> pd = *reinterpret_cast<const Pack<T, VEC>*>(
            db + (long long)(q0 + r) * A.ds[2] + c * VEC);
#pragma unroll
        for (int j = 0; j < VEC; ++j) s = fmaf(to_f(po.v[j]), to_f(pd.v[j]), s);
      }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (part == 0) Ds[r] = s;
  }
  __syncthreads();

  const long long n = (long long)gridDim.x * A.sq;
  float m[4], inv_l[4], di[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const long long idx = (long long)bh * A.sq + row;
    const bool in = row < A.sq;
    m[i] = in ? stats[idx] : 0.0f;
    inv_l[i] = in ? 1.0f / stats[n + idx] : 0.0f;
    di[i] = Ds[ty * 4 + i];
    if (tx == 0 && in) di_out[idx] = di[i];
  }
  int cvs[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) cvs[c] = min(tx + TX * c, NCV - 1);

  float acc[4][CPT][VW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c)
#pragma unroll
      for (int w = 0; w < VW; ++w) acc[i][c][w] = 0.0f;

  // V and K alternate in their slots: V of tile t + 1 lands while the
  // block forms S and dq of tile t, K of tile t while it forms dP
  for (int t = lo; t < hi; ++t) {
    const int k0 = t * BK;
    cp_wait_all();
    __syncthreads();      // V of tile t landed; the last tile's reads done
    issue_k(t);
    if constexpr (S::RAW) {
      widen_rows<D, BK, NT, VL>(Vs, Vraw);
      __syncthreads();
    }

    float sc[4][CK], dp[4][CK];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) sc[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int u = 0; u < NU; ++u) {       // dP = do V^T
      float4 vf[CK];
#pragma unroll
      for (int j = 0; j < CK; ++j)
        vf[j] = *reinterpret_cast<const float4*>(Vs + VL::at(tx + TX * j, u));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 g = *reinterpret_cast<const float4*>(
            dOs + QL::at(ty * 4 + i, u));
#pragma unroll
        for (int j = 0; j < CK; ++j) {
          float y = fmaf(g.x, vf[j].x, dp[i][j]);
          y = fmaf(g.y, vf[j].y, y);
          y = fmaf(g.z, vf[j].z, y);
          dp[i][j] = fmaf(g.w, vf[j].w, y);
        }
      }
    }
    cp_wait_all();
    __syncthreads();      // K of tile t landed; V read
    if (t + 1 < hi) issue_v(t + 1);
    if constexpr (S::RAW) {
      widen_rows<D, BK, NT, KL>(Ks, Kraw);
      __syncthreads();
    }
#pragma unroll 4
    for (int u = 0; u < NU; ++u) {       // S = q K^T
      float4 kf[CK];
#pragma unroll
      for (int j = 0; j < CK; ++j)
        kf[j] = *reinterpret_cast<const float4*>(Ks + KL::at(tx + TX * j, u));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(
            Qs + QL::at(ty * 4 + i, u));
#pragma unroll
        for (int j = 0; j < CK; ++j) {
          float x = fmaf(a.x, kf[j].x, sc[i][j]);
          x = fmaf(a.y, kf[j].y, x);
          x = fmaf(a.z, kf[j].z, x);
          sc[i][j] = fmaf(a.w, kf[j].w, x);
        }
      }
    }

    const bool edge = !A.all_visible(q0, BQ, k0, BK);
#pragma unroll
    for (int j = 0; j < CK; ++j) {
      const int key = k0 + tx + TX * j;
      float d4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty * 4 + i;
        float ds = expf(sc[i][j] - m[i]) * inv_l[i] * (dp[i][j] - di[i]);
        if (edge) {
          const bool real = row < A.sq && key < A.skv;
          if (!real || (!A.visible(row, key) &&
                        fault != FAULT_MASK_NOT_ZEROED))
            ds = 0.0f;
        }
        d4[i] = ds;
      }
      *reinterpret_cast<float4*>(dSt + (tx + TX * j) * SP + ty * 4) =
          make_float4(d4[0], d4[1], d4[2], d4[3]);
    }
    __syncthreads();      // dS written

#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float4 d = *reinterpret_cast<const float4*>(dSt + kk * SP + ty * 4);
      const float dv[4] = {d.x, d.y, d.z, d.w};
      float kv[CPT][VW];
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        read_vec<VW>(Ks + KL::at(kk, 0) + cvs[c] * VW, kv[c]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c)
#pragma unroll
          for (int w = 0; w < VW; ++w)
            acc[i][c][w] = fmaf(dv[i], kv[c][w], acc[i][c][w]);
    }
  }
  cp_wait_all();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= A.sq) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      if (tx + TX * c >= NCV) continue;
      float x[VW];
#pragma unroll
      for (int w = 0; w < VW; ++w) x[w] = acc[i][c][w] * A.scale;
      write_vec<T, VW>(dq + ((long long)bh * A.sq + row) * D +
                           (tx + TX * c) * VW, x);
    }
  }
}

// ---- dk, dv: per (batch * key/value head, BK keys), BQ query rows a tile
template <typename T, int D>
struct DkvShape {
  using C = Plan<D>;
  static constexpr int BK = 64, BQ = C::BQ, VW = C::VW;
  static constexpr int NT = 4 * BQ;
  static constexpr int NU = D / 4, NCV = D / VW;
  // S^T and dP^T: keys KS ty .. KS ty + KS - 1 x rows tx + 8 i
  static constexpr int TXS = 8, TYS = NT / TXS, KS = BK / TYS;
  static constexpr int RS = BQ / TXS;
  // dk and dv: keys KA ya .. KA ya + KA - 1 x column vector xa
  static constexpr int TXA = NCV > 16 ? 32 : 16, TYA = NT / TXA;
  static constexpr int KA = BK / TYA;
  static constexpr bool RAW = sizeof(T) == 2;
  using KL = UnitMajor<D, BK>;
  using QL = SwizzledRows<D, BQ>;
  static constexpr int SMEM =
      (2 * KL::FLOATS + 2 * BQ * BK + 2 * QL::FLOATS) * 4 +
      (RAW ? 2 * BQ * D * (int)sizeof(T) : 0);
  static constexpr int MINB = Resident<SMEM, C::MINB>::VALUE;
  static_assert(NCV <= TXA && KA % 4 == 0 && KS % 2 == 0 && BK / 4 >= 8,
                "thread maps");
};

// P and dS rows [BQ][BK]: 4-key chunk c of row r at chunk c ^ (r & 7)
template <int BK>
__device__ __forceinline__ int pk_at(int r, int key) {
  return r * BK + (((key >> 2) ^ (r & 7)) << 2) + (key & 3);
}

template <typename T, int D>
__global__ void __launch_bounds__(DkvShape<T, D>::NT, DkvShape<T, D>::MINB)
fa_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           T* __restrict__ dk, T* __restrict__ dv,
           const float* __restrict__ stats, const float* __restrict__ di,
           Attn A, int batch, int fault) {
  using S = DkvShape<T, D>;
  constexpr int BK = S::BK, BQ = S::BQ, NT = S::NT, VW = S::VW;
  constexpr int NU = S::NU, NCV = S::NCV, RS = S::RS, KA = S::KA;
  constexpr int KS = S::KS, TXS = S::TXS, TXA = S::TXA;
  using KL = typename S::KL;
  using QL = typename S::QL;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                       // [NU][BK][4]
  float* Vs = Ks + KL::FLOATS;            // [NU][BK][4]
  float* Ps = Vs + KL::FLOATS;            // [BQ][BK], chunks swizzled
  float* dSs = Ps + BQ * BK;              // [BQ][BK], chunks swizzled
  float* Qw = dSs + BQ * BK;              // the q slot, swizzled rows
  float* dOw = Qw + QL::FLOATS;           // the do slot
  T* Qraw = reinterpret_cast<T*>(dOw + QL::FLOATS);   // bfloat16: [BQ][D]
  T* dOraw = Qraw + BQ * D;

  const int tid = threadIdx.x;
  const int txs = tid % TXS, tys = tid / TXS;
  const int xa = tid % TXA, ya = tid / TXA;
  const int bkv = blockIdx.x;
  const int b = bkv / A.hkv, hk = bkv % A.hkv;
  const int k0 = blockIdx.y * BK, k1 = min(k0 + BK, A.skv) - 1;
  const long long n = (long long)batch * A.hq * A.sq;
  const int n_qt = (A.sq + BQ - 1) / BQ;
  const int heads = fault == FAULT_HEAD_DROPPED ? A.group - 1 : A.group;
  const int total = heads * n_qt;

  auto next_live = [&](int it) {
    for (; it < total; ++it) {
      const int q0 = (it % n_qt) * BQ;
      if (A.tile_live(q0, min(q0 + BQ, A.sq) - 1, k0, k1)) break;
    }
    return it;
  };
  // q and do of step `it` into their slots (float32 straight into the
  // swizzled rows, bfloat16 raw)
  auto issue = [&](int it, const T* src, const long long* st, float* work,
                   T* raw) {
    const int h = hk * A.group + it / n_qt, q0 = (it % n_qt) * BQ;
    const T* base = src + b * st[0] + h * st[1];
    if constexpr (S::RAW)
      issue_rows<T, D, BQ, NT, QL>(raw, base, st[2], q0, A.sq);
    else
      issue_rows<T, D, BQ, NT, QL>(work, base, st[2], q0, A.sq);
    cp_commit();
  };

  int it = next_live(0);
  if (it < total) issue(it, dout, A.ds, dOw, dOraw);
  load_rows<T, D, BK, NT, KL>(Ks, k + b * A.ks[0] + hk * A.ks[1], A.ks[2],
                              k0, A.skv, 1.0f);
  load_rows<T, D, BK, NT, KL>(Vs, v + b * A.vs[0] + hk * A.vs[1], A.vs[2],
                              k0, A.skv, 1.0f);
  const int cva = min(xa, NCV - 1);
  float acc_k[KA][VW], acc_v[KA][VW];
#pragma unroll
  for (int kk = 0; kk < KA; ++kk)
#pragma unroll
    for (int w = 0; w < VW; ++w) acc_k[kk][w] = acc_v[kk][w] = 0.0f;

  while (it < total) {
    const int nxt = next_live(it + 1);
    const int h = hk * A.group + it / n_qt, q0 = (it % n_qt) * BQ;
    // the rows' statistics, read now and used after the products
    float mr[RS], lr[RS], dr[RS];
#pragma unroll
    for (int i = 0; i < RS; ++i) {
      const int row = q0 + txs + TXS * i;
      const long long idx = ((long long)b * A.hq + h) * A.sq + row;
      const bool in = row < A.sq;
      mr[i] = in ? stats[idx] : 0.0f;
      lr[i] = in ? stats[n + idx] : 0.0f;
      dr[i] = in ? di[idx] : 0.0f;
    }
    cp_wait_all();
    __syncthreads();      // do landed; the last step's reads are done
    issue(it, q, A.qs, Qw, Qraw);
    if constexpr (S::RAW) {
      widen_rows<D, BQ, NT, QL>(dOw, dOraw);
      __syncthreads();
    }

    float sc[KS][RS], dp[KS][RS];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int i = 0; i < RS; ++i) sc[kk][i] = dp[kk][i] = 0.0f;
#pragma unroll 4
    for (int u = 0; u < NU; ++u) {       // dP^T = V do^T
      float4 vf[KS];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        vf[kk] = *reinterpret_cast<const float4*>(Vs +
                                                  KL::at(tys * KS + kk, u));
#pragma unroll
      for (int i = 0; i < RS; ++i) {
        const float4 g = *reinterpret_cast<const float4*>(
            dOw + QL::at(txs + TXS * i, u));
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          float y = fmaf(g.x, vf[kk].x, dp[kk][i]);
          y = fmaf(g.y, vf[kk].y, y);
          y = fmaf(g.z, vf[kk].z, y);
          dp[kk][i] = fmaf(g.w, vf[kk].w, y);
        }
      }
    }
    cp_wait_all();
    __syncthreads();      // q landed
    if constexpr (S::RAW) {
      widen_rows<D, BQ, NT, QL>(Qw, Qraw);
      __syncthreads();
    }
#pragma unroll 4
    for (int u = 0; u < NU; ++u) {       // S^T = K q^T
      float4 kf[KS];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        kf[kk] = *reinterpret_cast<const float4*>(Ks +
                                                  KL::at(tys * KS + kk, u));
#pragma unroll
      for (int i = 0; i < RS; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(
            Qw + QL::at(txs + TXS * i, u));
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          float x = fmaf(a.x, kf[kk].x, sc[kk][i]);
          x = fmaf(a.y, kf[kk].y, x);
          x = fmaf(a.z, kf[kk].z, x);
          sc[kk][i] = fmaf(a.w, kf[kk].w, x);
        }
      }
    }

    const bool edge = !A.all_visible(q0, BQ, k0, BK);
#pragma unroll
    for (int i = 0; i < RS; ++i) {
      const int r = txs + TXS * i, row = q0 + r;
      const float il = row < A.sq ? 1.0f / lr[i] : 0.0f;
      float pv[KS], dsv[KS];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const float s = sc[kk][i] * A.scale;
        float p = expf(s - mr[i]) * il;
        float ds = p * (dp[kk][i] - dr[i]);
        if (edge) {
          const int key = k0 + tys * KS + kk;
          const bool real = row < A.sq && key < A.skv;
          const bool vis = real && A.visible(row, key);
          // a masked score is -1e30: P is 0 there unless the row sees no
          // key at all, where it is 1/Skv as in the forward
          if (!vis) {
            if (!(real && fault == FAULT_MASK_NOT_ZEROED)) ds = 0.0f;
            p = real ? expf(MASKED - mr[i]) * il : 0.0f;
          }
        }
        pv[kk] = p;
        dsv[kk] = ds;
      }
#pragma unroll
      for (int kk = 0; kk < KS; kk += 2) {
        *reinterpret_cast<float2*>(Ps + pk_at<BK>(r, tys * KS + kk)) =
            make_float2(pv[kk], pv[kk + 1]);
        *reinterpret_cast<float2*>(dSs + pk_at<BK>(r, tys * KS + kk)) =
            make_float2(dsv[kk], dsv[kk + 1]);
      }
    }
    __syncthreads();      // P and dS written

#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {       // dv += P^T do
      float pk[KA], gv[VW];
#pragma unroll
      for (int kk = 0; kk < KA; kk += 4) {
        const float4 p = *reinterpret_cast<const float4*>(
            Ps + pk_at<BK>(r, ya * KA + kk));
        pk[kk] = p.x, pk[kk + 1] = p.y, pk[kk + 2] = p.z, pk[kk + 3] = p.w;
      }
      read_vec<VW>(dOw + QL::at(r, cva * VW / 4) + cva * VW % 4, gv);
#pragma unroll
      for (int kk = 0; kk < KA; ++kk)
#pragma unroll
        for (int w = 0; w < VW; ++w)
          acc_v[kk][w] = fmaf(pk[kk], gv[w], acc_v[kk][w]);
    }
    __syncthreads();      // do read: its slot takes the next step's
    if (nxt < total) issue(nxt, dout, A.ds, dOw, dOraw);
#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {       // dk += dS^T q
      float sk[KA], qv[VW];
#pragma unroll
      for (int kk = 0; kk < KA; kk += 4) {
        const float4 d = *reinterpret_cast<const float4*>(
            dSs + pk_at<BK>(r, ya * KA + kk));
        sk[kk] = d.x, sk[kk + 1] = d.y, sk[kk + 2] = d.z, sk[kk + 3] = d.w;
      }
      read_vec<VW>(Qw + QL::at(r, cva * VW / 4) + cva * VW % 4, qv);
#pragma unroll
      for (int kk = 0; kk < KA; ++kk)
#pragma unroll
        for (int w = 0; w < VW; ++w)
          acc_k[kk][w] = fmaf(sk[kk], qv[w], acc_k[kk][w]);
    }
    it = nxt;
  }
  cp_wait_all();

  if (xa < NCV) {
    const long long base = (long long)bkv * A.skv;
#pragma unroll
    for (int kk = 0; kk < KA; ++kk) {
      const int key = k0 + ya * KA + kk;
      if (key >= A.skv) continue;
      float x[VW];
#pragma unroll
      for (int w = 0; w < VW; ++w) x[w] = acc_k[kk][w] * A.scale;
      write_vec<T, VW>(dk + (base + key) * D + xa * VW, x);
      write_vec<T, VW>(dv + (base + key) * D + xa * VW, acc_v[kk]);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv,
           const float* stats, float* di, int b, const Attn& A, int fault,
           cudaStream_t stream) {
  using Q = DqShape<T, D>;
  using K = DkvShape<T, D>;
  // per device and cheap, so set on every launch
  cudaError_t e = cudaFuncSetAttribute(
      fa_bwd_dq<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Q::SMEM);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(fa_bwd_dkv<T, D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           K::SMEM);
  if (e != cudaSuccess) return (int)e;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dt = static_cast<const T*>(dout);
  fa_bwd_dq<T, D><<<dim3(b * A.hq, (A.sq + Q::BQ - 1) / Q::BQ), Q::NT,
                    Q::SMEM, stream>>>(qt, kt, vt, static_cast<const T*>(o),
                                       dt, static_cast<T*>(dq), stats, di, A,
                                       fault);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fa_bwd_dkv<T, D><<<dim3(b * A.hkv, (A.skv + K::BK - 1) / K::BK), K::NT,
                     K::SMEM, stream>>>(
      qt, kt, vt, dt, static_cast<T*>(dk), static_cast<T*>(dv), stats, di,
      A, b, fault);
  return (int)cudaGetLastError();
}

// the plans (rows, tile, threads, ring stages, shared bytes, blocks an SM)
// of the dq launch into out[0..5] and of the dk/dv launch into out[6..11],
// and the blocks of each that one SM of the current card holds at once (the
// occupancy calculator) into out[12] and out[13]
template <typename T, int D>
int plan_d(int* out) {
  using Q = DqShape<T, D>;
  using K = DkvShape<T, D>;
  const int v[12] = {Q::BQ, Q::BK, Q::NT, STAGES, Q::SMEM, Q::MINB,
                     K::BK, K::BQ, K::NT, STAGES, K::SMEM, K::MINB};
  for (int i = 0; i < 12; ++i) out[i] = v[i];
  const int e = blocks_per_sm(fa_bwd_dq<T, D>, Q::NT, Q::SMEM, out + 12);
  if (e != 0) return e;
  return blocks_per_sm(fa_bwd_dkv<T, D>, K::NT, K::SMEM, out + 13);
}

template <typename T>
int plan(int d, int* out) {
  switch (d) {
    case 16: return plan_d<T, 16>(out);
    case 32: return plan_d<T, 32>(out);
    case 64: return plan_d<T, 64>(out);
    case 112: return plan_d<T, 112>(out);
    case 128: return plan_d<T, 128>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v,
             const void* o, const void* dout, void* dq, void* dk, void* dv,
             const float* st, float* di, int b, const Attn& A, int fault,
             cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, dout, dq, dk, dv, st, di, b, A,
                                  fault, s);
    case 32: return launch<T, 32>(q, k, v, o, dout, dq, dk, dv, st, di, b, A,
                                  fault, s);
    case 64: return launch<T, 64>(q, k, v, o, dout, dq, dk, dv, st, di, b, A,
                                  fault, s);
    case 112: return launch<T, 112>(q, k, v, o, dout, dq, dk, dv, st, di, b,
                                    A, fault, s);
    case 128: return launch<T, 128>(q, k, v, o, dout, dq, dk, dv, st, di, b,
                                    A, fault, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches both kernels on `stream` and returns cudaGetLastError(); never
// synchronises and allocates nothing.  dtype 0 is float32, 1 bfloat16 (every
// tensor but `stats` and `di` of it); d is 16, 32, 64, 112 or 128.
// `strides` holds the element strides over (batch, head, position) of q, k,
// v, o and do, in that order, fifteen in all; each last dimension is
// contiguous and every row 16-byte aligned.  dq is (b, hq, sq, d), dk and
// dv (b, hkv, skv, d), contiguous; `stats` is the forward's float32
// (2, b, hq, sq) of each row's m and l; `di` is float32 scratch of
// b * hq * sq.  window <= 0 means no window; `fault` is 0 but in
// chip_smoke.py's planted faults.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, const void* stats,
    void* di, int b, int hq, int hkv, int sq, int skv, int d,
    const long long* strides, int causal, int window, float scale, int dtype,
    int fault, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  Attn A{hq, hkv, hq / hkv, sq, skv, causal, window, scale, {}, {}, {}, {},
         {}};
  for (int i = 0; i < 3; ++i) {
    A.qs[i] = strides[i];
    A.ks[i] = strides[3 + i];
    A.vs[i] = strides[6 + i];
    A.os[i] = strides[9 + i];
    A.ds[i] = strides[12 + i];
  }
  const float* st = static_cast<const float*>(stats);
  float* dd = static_cast<float*>(di);
  if (dtype == 0)
    return launch_d<float>(d, q, k, v, o, dout, dq, dk, dv, st, dd, b, A,
                           fault, stream);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(d, q, k, v, o, dout, dq, dk, dv, st, dd, b,
                                   A, fault, stream);
  return (int)cudaErrorInvalidValue;
}

// The launch plans of the dq and the dk/dv kernels at head dim d and
// dtype, as this build instantiates them, into out[0..5] and out[6..11]:
// rows a block and a step's tile (query rows and keys for dq, keys and
// query rows for dk/dv), threads, cp.async stages, dynamic shared bytes and
// the blocks an SM its __launch_bounds__ asks for (kernel.py's simt_plan
// states the same); and into out[12] and out[13] the blocks of each that
// one SM of the current card holds at once (the CUDA occupancy calculator).
extern "C" int flash_attention_bwd_plan(int d, int dtype, int* out) {
  if (dtype == 0) return plan<float>(d, out);
  if (dtype == 1) return plan<__nv_bfloat16>(d, out);
  return (int)cudaErrorInvalidValue;
}

// Name of a CUDA error code, for the wrapper's exception text.
extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
