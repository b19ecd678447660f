// Flash attention for Hopper (sm_90a), the SIMT route: blockwise
// online-softmax attention with grouped-query heads, a causal mask aligned
// at the sequence ends and an optional sliding window, in float32 FMAs
// outside the tensor cores, for float32 and for bfloat16 at head dims 16 and
// 32.
//
// Replaces the Pallas TPU kernel `_fa_kernel`, launched by `flash_attention`
// (src/repro/kernels/flash_attention/kernel.py).  Plain version:
// src/repro_torch/kernels/flash_attention/ref.py.  Binding and launch plan
// (`simt_plan`): src/repro_torch/kernels/flash_attention/kernel.py (ctypes).
//
// What it computes.  q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D); query head h
// reads key/value head h / (Hq / Hkv).  Query row i sits at position
// q_pos = i + Skv - Sq; key j is kept when j <= q_pos (causal) and
// j > q_pos - window (window).  q is scaled by `scale` in float32 before the
// product.  A masked logit is the finite -1e30 of the JAX package, never
// -inf: a row whose first tiles are all masked (a window) then carries
// exp(-1e30 - -1e30) = 1 terms until a real key arrives, and
// exp(-1e30 - m) = 0 wipes them.  A row that sees no key at all (a causal
// row before the first key when Sq > Skv) gets the mean of v over every key,
// as ref.py gives; the Pallas kernel gave 0 there.  Keys past Skv are
// absent (-inf), not masked.
//
// What bounds it.  4 * D operations per visible (query, key) pair, 687 GFLOP
// for q (4, 40, 4096, 128) causal, against 0.40 GB of inputs and outputs:
// bound by operations, here full IEEE float32 FMAs (67 TFLOP/s at most; no
// TF32).  An SM issues one warp instruction a clock on each of its four
// schedulers, so every instruction that is not an FMA costs an FMA: the
// design keeps the loads, the softmax and the staging a small share of the
// instructions.  bfloat16 at D 64, 112 and 128, the main path, takes the
// tensor-core kernel of csrc/flash_attention_wgmma.cu instead.
//
// Design (Hopper).  One block per (batch * query head, query
// tile of BQ rows), gridded so that every head's heaviest causal tiles
// launch first; a loop inside the block over BK-key tiles takes the place of
// the TPU's sequential fori_loop, stopping at the causal bound and starting
// at the window's first tile.  Thread (ty, tx) of a (BQ / RQ) x 16 grid
// owns RQ query rows (two runs of four at D >= 64, one below) for the scores
// and for the output: S = Q K^T as an RQ x 4 register tile (keys tx + 16 j),
// O as RQ rows x D / 16 columns, so each float read from shared memory feeds
// 4 to 8 FMAs; a row's max, sum and output stay in the registers of the 16
// lanes that share ty, and row reductions are 16-lane shuffles.  Q is read
// once, scaled and widened through registers, into [D/4][BQ][4] (the 16
// lanes of a row group read one address); K lands in [D/4][BK][4] (lanes on
// neighbouring keys), V in plain rows, P through [BK][BQ] with its 4-row
// chunks XOR-swizzled by the key's low three bits, so no read or write
// conflicts.  K and V arrive by cp.async in a two-slot ring in which they
// alternate: V of tile t is in flight while the block scores K of tile t,
// and K of tile t + 1 while it runs P V of tile t (bfloat16 lands raw and
// is widened once by the block).  Two barriers a tile (four in bfloat16).
// Shared memory at D 128: 112 KB, two blocks an SM (`simt_plan`).  The ends
// of Sq and Skv are masked in the kernel, so no length needs to divide a
// tile, and only tiles that straddle a mask edge test the mask.  When the
// caller passes a `stats` buffer (autograd's forward) the epilogue also
// writes each row's max m and sum l, the row statistics the backward
// (csrc/flash_attention_bwd.cu) reads.

#include "flash_attention_simt.cuh"

namespace {

using namespace simt;

// the launch plan of each head dim (MINB: blocks an SM, capped lower where
// shared memory holds fewer); kernel.py's simt_plan states the same
template <int D> struct Fwd;
template <> struct Fwd<128> {
  static constexpr int BQ = 64, BK = 64, RQ = 8, VW = 4, MINB = 2;
};
template <> struct Fwd<112> {
  static constexpr int BQ = 64, BK = 64, RQ = 8, VW = 4, MINB = 2;
};
template <> struct Fwd<64> {
  static constexpr int BQ = 64, BK = 64, RQ = 8, VW = 4, MINB = 3;
};
template <> struct Fwd<32> {
  static constexpr int BQ = 64, BK = 64, RQ = 4, VW = 2, MINB = 3;
};
template <> struct Fwd<16> {
  static constexpr int BQ = 64, BK = 64, RQ = 4, VW = 1, MINB = 3;
};

constexpr int TX = 16;       // lanes that share a query row

template <typename T, int D>
struct FwdShape {
  using C = Fwd<D>;
  static constexpr int BQ = C::BQ, BK = C::BK, RQ = C::RQ, VW = C::VW;
  static constexpr int TY = BQ / RQ, NT = TY * TX;
  static constexpr int NU = D / 4;              // 16-byte units of a row
  static constexpr int CK = BK / TX;            // keys a thread scores
  static constexpr int NG = RQ / 4;             // runs of 4 rows a thread owns
  static constexpr int NCV = D / VW;            // output column vectors
  static constexpr int CPT = (NCV + TX - 1) / TX;
  static constexpr bool RAW = sizeof(T) == 2;   // bfloat16 lands raw
  using QL = UnitMajor<D, BQ>;
  using KL = UnitMajor<D, BK>;
  using VL = PlainRows<D, BK>;
  static constexpr int SMEM =
      (QL::FLOATS + KL::FLOATS + VL::FLOATS + BK * BQ) * 4 +
      (RAW ? 2 * BK * D * (int)sizeof(T) : 0);
  // blocks an SM: the head dim's cap, or fewer where shared memory says so
  static constexpr int FIT = SM_SMEM / (SMEM + BLOCK_RESERVED);
  static constexpr int MINB = FIT < C::MINB ? FIT : C::MINB;
  static_assert(BQ % (4 * NG) == 0 && TY * RQ == BQ, "tile");
  static_assert(CK * TX == BK && BK % 8 == 0, "key tile");
  static_assert(BQ / 4 >= 8, "the P swizzle needs 8 row chunks");
};

template <typename T, int D>
__global__ void __launch_bounds__(FwdShape<T, D>::NT, FwdShape<T, D>::MINB)
fa_fwd(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, T* __restrict__ out,
       float* __restrict__ stats, int hq, int group, int sq, int skv,
       long long qsb, long long qsh, long long qss, long long ksb,
       long long ksh, long long kss, long long vsb, long long vsh,
       long long vss, int causal, int window, float scale) {
  using S = FwdShape<T, D>;
  constexpr int BQ = S::BQ, BK = S::BK, RQ = S::RQ, NT = S::NT, TY = S::TY;
  constexpr int NU = S::NU, CK = S::CK, NG = S::NG, VW = S::VW;
  constexpr int NCV = S::NCV, CPT = S::CPT;
  using QL = typename S::QL;
  using KL = typename S::KL;
  using VL = typename S::VL;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                         // [NU][BQ][4], scaled
  float* Ks = Qs + QL::FLOATS;              // [NU][BK][4]
  float* Vs = Ks + KL::FLOATS;              // [BK][D]
  float* Pt = Vs + VL::FLOATS;              // [BK][BQ], chunks swizzled
  T* Kraw = reinterpret_cast<T*>(Pt + BK * BQ);   // bfloat16: [BK][D]
  T* Vraw = Kraw + BK * D;

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;   // heaviest tiles first
  const int b = bh / hq, h = bh % hq, hk = h / group;
  const int q0 = qt * BQ;
  const int off = skv - sq;                    // q_pos = row + off
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  // the key tiles this query tile needs
  const int first_pos = q0 + off;
  const int last_pos = min(q0 + BQ, sq) - 1 + off;
  int lo = 0, hi = (skv + BK - 1) / BK;
  if (!causal || first_pos >= 0) {
    // every row sees a key, so tiles that every row masks can be skipped
    if (causal) hi = min(hi, last_pos / BK + 1);
    if (window > 0) lo = max(0, first_pos - window + 1) / BK;
  }  // else rows before the first key average every key: visit them all

  auto issue_k = [&](int t) {
    if constexpr (S::RAW)
      issue_rows<T, D, BK, NT, KL>(Kraw, kb, kss, t * BK, skv);
    else
      issue_rows<T, D, BK, NT, KL>(Ks, kb, kss, t * BK, skv);
    cp_commit();
  };
  auto issue_v = [&](int t) {
    if constexpr (S::RAW)
      issue_rows<T, D, BK, NT, VL>(Vraw, vb, vss, t * BK, skv);
    else
      issue_rows<T, D, BK, NT, VL>(Vs, vb, vss, t * BK, skv);
    cp_commit();
  };

  if (lo < hi) issue_k(lo);
  load_rows<T, D, BQ, NT, QL>(Qs, qb, qss, q0, sq, scale);

  // this thread's rows: run g of four at g * BQ / NG + 4 ty
  int rows[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) rows[i] = (i / 4) * (BQ / NG) + ty * 4 + i % 4;
  float m[RQ], l[RQ], acc[RQ][CPT][VW];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = MASKED;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
#pragma unroll
      for (int w = 0; w < VW; ++w) acc[i][c][w] = 0.0f;
  }
  // the output column vectors this thread owns (past NCV: a copy of a real
  // one, computed and never stored)
  int cvs[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) cvs[c] = min(tx + TX * c, NCV - 1);
  const int swz_w = tx & 7;        // key & 7 of every key this thread scores

  for (int t = lo; t < hi; ++t) {
    const int k0 = t * BK;
    cp_wait_all();
    __syncthreads();               // K of tile t landed; P V of t - 1 done
    issue_v(t);
    if constexpr (S::RAW) {
      widen_rows<D, BK, NT, KL>(Ks, Kraw);
      __syncthreads();
    }

    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int u = 0; u < NU; ++u) {
      float4 kf[CK];
#pragma unroll
      for (int j = 0; j < CK; ++j)
        kf[j] = *reinterpret_cast<const float4*>(Ks + KL::at(tx + TX * j, u));
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(Qs + QL::at(rows[i],
                                                                      u));
#pragma unroll
        for (int j = 0; j < CK; ++j) {
          float x = fmaf(a.x, kf[j].x, s[i][j]);
          x = fmaf(a.y, kf[j].y, x);
          x = fmaf(a.z, kf[j].z, x);
          s[i][j] = fmaf(a.w, kf[j].w, x);
        }
      }
    }

    // a tile that straddles a mask edge, the keys' end or a row that sees
    // no key tests every pair; the others are all visible
    const bool edge = k0 + BK > skv || (causal && k0 + BK - 1 > first_pos) ||
                      (window > 0 && k0 <= last_pos - window);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int q_pos = q0 + rows[i] + off;
      float mx = MASKED;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        if (edge) {
          const int k_pos = k0 + tx + TX * j;
          if (k_pos >= skv)
            s[i][j] = -CUDART_INF_F;     // not a key: contributes nothing
          else if ((causal && k_pos > q_pos) ||
                   (window > 0 && k_pos <= q_pos - window))
            s[i][j] = MASKED;
        }
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max<TX>(mx));   // finite
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + group_sum<TX>(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c)
#pragma unroll
        for (int w = 0; w < VW; ++w) acc[i][c][w] *= alpha;
    }
    // P transposed: key tx + 16 j, the chunk of rows 4 (g TY + ty) .. + 3
#pragma unroll
    for (int j = 0; j < CK; ++j)
#pragma unroll
      for (int g = 0; g < NG; ++g)
        *reinterpret_cast<float4*>(
            Pt + (tx + TX * j) * BQ + (((g * TY + ty) ^ swz_w) * 4)) =
            make_float4(s[4 * g][j], s[4 * g + 1][j], s[4 * g + 2][j],
                        s[4 * g + 3][j]);

    cp_wait_all();
    __syncthreads();               // V of tile t landed; P written; K read
    if (t + 1 < hi) issue_k(t + 1);
    if constexpr (S::RAW) {
      widen_rows<D, BK, NT, VL>(Vs, Vraw);
      __syncthreads();
    }

#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float4 p[NG];
#pragma unroll
      for (int g = 0; g < NG; ++g)
        p[g] = *reinterpret_cast<const float4*>(
            Pt + kk * BQ + (((g * TY + ty) ^ (kk & 7)) * 4));
      float vv[CPT][VW];
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        read_vec<VW>(Vs + kk * D + cvs[c] * VW, vv[c]);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float pv[4] = {p[g].x, p[g].y, p[g].z, p[g].w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int c = 0; c < CPT; ++c)
#pragma unroll
            for (int w = 0; w < VW; ++w)
              acc[4 * g + e][c][w] = fmaf(pv[e], vv[c][w],
                                          acc[4 * g + e][c][w]);
      }
    }
  }
  cp_wait_all();

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + rows[i];
    if (row >= sq) continue;
    const float denom = l[i] == 0.0f ? 1.0f : l[i];
    const long long idx = (long long)bh * sq + row;
    if (stats != nullptr && tx == 0) {
      stats[idx] = m[i];
      stats[(long long)gridDim.x * sq + idx] = l[i];
    }
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      if (tx + TX * c >= NCV) continue;
      float o[VW];
#pragma unroll
      for (int w = 0; w < VW; ++w) o[w] = acc[i][c][w] / denom;
      write_vec<T, VW>(out + idx * D + (tx + TX * c) * VW, o);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out,
           float* stats, int b, int hq, int hkv, int sq, int skv,
           const long long* st, int causal, int window, float scale,
           cudaStream_t stream) {
  using S = FwdShape<T, D>;
  // per device and cheap, so set on every launch
  const cudaError_t e = cudaFuncSetAttribute(
      fa_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(b * hq, (sq + S::BQ - 1) / S::BQ);
  fa_fwd<T, D><<<grid, S::NT, S::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), stats, hq, hq / hkv,
      sq, skv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      causal, window, scale);
  return (int)cudaGetLastError();
}

// the plan (rows, key tile, threads, ring stages, shared bytes, blocks an
// SM) into out[0..5], and the blocks that one SM of the current card holds
// at once (the occupancy calculator) into out[6]
template <typename T, int D>
int plan_d(int* out) {
  using S = FwdShape<T, D>;
  const int v[6] = {S::BQ, S::BK, S::NT, STAGES, S::SMEM, S::MINB};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return blocks_per_sm(fa_fwd<T, D>, S::NT, S::SMEM, out + 6);
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
int launch_d(int d, const void* q, const void* k, const void* v, void* out,
             float* stats, int b, int hq, int hkv, int sq, int skv,
             const long long* st, int causal, int window, float scale,
             cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, out, stats, b, hq, hkv, sq, skv,
                                  st, causal, window, scale, s);
    case 32: return launch<T, 32>(q, k, v, out, stats, b, hq, hkv, sq, skv,
                                  st, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, stats, b, hq, hkv, sq, skv,
                                  st, causal, window, scale, s);
    case 112: return launch<T, 112>(q, k, v, out, stats, b, hq, hkv, sq, skv,
                                    st, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, stats, b, hq, hkv, sq, skv,
                                    st, causal, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); never synchronises
// and allocates nothing.  dtype 0 is float32, 1 bfloat16 (q, k, v and out
// all of it); d is 16, 32, 64, 112 or 128 (the route sends bfloat16 here
// at 16 and 32 only; chip_smoke.py times the rest beside the tensor-core
// kernel).  `strides`
// holds the element strides of q, k and v over (batch, head, position), in
// that order, nine in all; the last dimension is contiguous and every row
// 16-byte aligned.  `out` is (b, hq, sq, d) contiguous.  `stats` is null, or
// float32 (2, b, hq, sq) that receives each row's m and l.  window <= 0
// means no window.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* stats,
                                      int b, int hq, int hkv, int sq, int skv,
                                      int d, const long long* strides,
                                      int causal, int window, float scale,
                                      int dtype, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  float* st = static_cast<float*>(stats);
  if (dtype == 0)
    return launch_d<float>(d, q, k, v, out, st, b, hq, hkv, sq, skv, strides,
                           causal, window, scale, stream);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(d, q, k, v, out, st, b, hq, hkv, sq, skv,
                                   strides, causal, window, scale, stream);
  return (int)cudaErrorInvalidValue;
}

// The forward kernel's launch plan at head dim d and dtype, as this build
// instantiates it, into out[0..5]: query rows a block, keys a tile,
// threads, cp.async stages, dynamic shared bytes and the blocks an SM its
// __launch_bounds__ asks for (kernel.py's simt_plan states the same); and
// into out[6] the blocks one SM of the current card holds at once (the
// CUDA occupancy calculator: shared memory, registers and threads).
extern "C" int flash_attention_plan(int d, int dtype, int* out) {
  if (dtype == 0) return plan<float>(d, out);
  if (dtype == 1) return plan<__nv_bfloat16>(d, out);
  return (int)cudaErrorInvalidValue;
}

// Name of a CUDA error code, for the wrapper's exception text.
extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
