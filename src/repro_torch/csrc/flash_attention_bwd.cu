// Flash-attention backward for Hopper (sm_90a): the gradients dq, dk and dv
// of grouped-query attention with a causal mask aligned at the sequence
// ends and an optional sliding window, in float32 or bfloat16, given q, k,
// v, the forward's output o and the output's gradient do.
//
// The JAX package has no backward Pallas kernel: it trains through the
// plain jnp attention (`repro/models/transformer.py`, attn_impl="ref"), so
// this kernel is held against `jax.vjp` of that plain version and against
// autograd through the port's plain version
// (src/repro_torch/kernels/flash_attention/ref.py, whose `attention_bwd` is
// the same algorithm).  It is the backward of the SIMT forward
// (csrc/flash_attention.cu), whose route it shares: float32, and bfloat16
// at head dims 16 and 32.  Binding: src/repro_torch/kernels/
// flash_attention/kernel.py (ctypes).
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
// pair (S, dP and dq in the dq launch; S, dP, dk and dv in the dk/dv launch)
// against a few bytes per element of q, k, v, o and do: bound by
// operations.  This backward does them as float32 FMAs outside the tensor
// cores (67 TFLOP/s at most, against 989 in bfloat16 on them), so it serves
// float32 and head dims 16 and 32; bfloat16 at D 64, 112 and 128 takes the
// tensor-core backward of csrc/flash_attention_bwd_wgmma.cu.
//
// Design.  Two launches, each block owning its outputs, so no atomics and
// the result is deterministic.  Tiles of 64 query rows and 64 keys, 256
// threads as a 16 x 16 grid; operands are staged in shared memory in
// float32, transposed where a product walks them by column.
//   - `fa_bwd_dq`, one block per (batch * query head, 64-row query tile),
//     heaviest causal tiles first: Di, which it writes for the second
//     launch, then one pass over the key tiles that forms dS from the
//     forward's statistics and adds dS k into registers; thread (ty, tx)
//     owns rows 4ty..4ty+3 and D/16 columns.  180 KB of shared memory at D
//     128.
//   - `fa_bwd_dkv`, one block per (batch * key/value head, 64-key tile),
//     key tile 0 first: for each query head of the group and each query
//     tile that reaches the key tile, it recomputes P and dS from the
//     statistics and adds P^T do and dS^T q into registers, so the sum over
//     the group's heads needs no atomics; thread (ty, tx) owns D/16 columns
//     and keys 4tx..4tx+3.  161 KB at D 128.
// A tile pair is visited only when it holds a visible pair or a row that
// sees no key.  q, k, v, o and do are read at their strides (the heads
// views of the model's projections; do arrives as one); dq, dk and dv are
// contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int NT = 256;       // threads per block (16 x 16)
constexpr float MASKED = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// VEC elements from 16-byte-aligned p as float32, or zeros when !live
template <typename T, int VEC>
__device__ __forceinline__ void load_chunk(const T* p, bool live, float* f) {
  if (live) {
    const Pack<T, VEC> pk = *reinterpret_cast<const Pack<T, VEC>*>(p);
#pragma unroll
    for (int j = 0; j < VEC; ++j) f[j] = to_f(pk.v[j]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) f[j] = 0.0f;
  }
}

// rows [r0, r0 + ROWS) of a (rows, D) operand at row stride `rs`, times
// `mul`, into dst transposed: dst[d * ROWS + r]; rows at or past `n` are 0
template <typename T, int D, int ROWS>
__device__ __forceinline__ void stage_t(float* dst, const T* src, long long rs,
                                        int r0, int n, float mul) {
  constexpr int VEC = 16 / sizeof(T), CH = D / VEC;
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i % ROWS, c = i / ROWS;
    float f[VEC];
    load_chunk<T, VEC>(src + (long long)(r0 + r) * rs + c * VEC, r0 + r < n,
                       f);
#pragma unroll
    for (int j = 0; j < VEC; ++j) dst[(c * VEC + j) * ROWS + r] = f[j] * mul;
  }
}

// the same rows kept in their own layout: dst[r * D + d]
template <typename T, int D, int ROWS>
__device__ __forceinline__ void stage(float* dst, const T* src, long long rs,
                                      int r0, int n) {
  constexpr int VEC = 16 / sizeof(T), CH = D / VEC;
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    float f[VEC];
    load_chunk<T, VEC>(src + (long long)(r0 + r) * rs + c * VEC, r0 + r < n,
                       f);
#pragma unroll
    for (int j = 0; j < VEC; ++j) dst[r * D + c * VEC + j] = f[j];
  }
}

__device__ __forceinline__ float row16_max(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row16_sum(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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
};

// dq and Di per (batch * query head, query tile).  stats holds two
// (B * Hq * Sq) float32 arrays, m and l; di receives Di.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
fa_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ o,
          const T* __restrict__ dout, T* __restrict__ dq,
          const float* __restrict__ stats, float* __restrict__ di_out,
          Attn A) {
  constexpr int VEC = 16 / sizeof(T), CH = D / VEC, DC = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                       // [D][BQ], scaled
  float* dOt = Qt + D * BQ;               // [D][BQ]
  float* Kt = dOt + D * BQ;               // [D][BK]
  float* Vt = Kt + D * BK;                // [D][BK]
  float* Ks = Vt + D * BK;                // [BK][D]
  float* St = Ks + BK * D;                // [BK][BQ]: dS transposed
  float* Ds = St + BK * BQ;               // [BQ]: Di

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int b = blockIdx.y / A.hq, h = blockIdx.y % A.hq, hk = h / A.group;
  const int q0 = qt * BQ, i1 = min(q0 + BQ, A.sq) - 1;
  const int off = A.off();
  const T* qb = q + b * A.qs[0] + h * A.qs[1];
  const T* ob = o + b * A.os[0] + h * A.os[1];
  const T* db = dout + b * A.ds[0] + h * A.ds[1];
  const T* kb = k + b * A.ks[0] + hk * A.ks[1];
  const T* vb = v + b * A.vs[0] + hk * A.vs[1];

  stage_t<T, D, BQ>(Qt, qb, A.qs[2], q0, A.sq, A.scale);
  stage_t<T, D, BQ>(dOt, db, A.ds[2], q0, A.sq, 1.0f);
  {  // Di = rowsum(do * o), four threads a row
    const int r = tid >> 2, part = tid & 3;
    float s = 0.0f;
    if (q0 + r < A.sq)
      for (int c = part; c < CH; c += 4) {
        float fo[VEC], fd[VEC];
        load_chunk<T, VEC>(ob + (long long)(q0 + r) * A.os[2] + c * VEC,
                           true, fo);
        load_chunk<T, VEC>(db + (long long)(q0 + r) * A.ds[2] + c * VEC,
                           true, fd);
#pragma unroll
        for (int j = 0; j < VEC; ++j) s = fmaf(fo[j], fd[j], s);
      }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (part == 0) Ds[r] = s;
  }
  __syncthreads();

  const int n_kt = (A.skv + BK - 1) / BK;
  const long long n = (long long)gridDim.y * A.sq;
  float m[4], l[4], di[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const long long idx = (long long)blockIdx.y * A.sq + row;
    const bool in = row < A.sq;
    m[i] = in ? stats[idx] : 0.0f;
    l[i] = in ? stats[n + idx] : 1.0f;
    di[i] = Ds[ty * 4 + i];
    if (tx == 0 && in) di_out[idx] = di[i];
  }

  // dS, then dq += dS k
  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.0f;
  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * BK;
    if (!A.tile_live(q0, i1, k0, min(k0 + BK, A.skv) - 1)) continue;
    __syncthreads();                     // the last tile's Ks and St are read
    stage_t<T, D, BK>(Kt, kb, A.ks[2], k0, A.skv, 1.0f);
    stage_t<T, D, BK>(Vt, vb, A.vs[2], k0, A.skv, 1.0f);
    stage<T, D, BK>(Ks, kb, A.ks[2], k0, A.skv);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[dd * BQ + ty * 4]);
      const float4 g = *reinterpret_cast<const float4*>(&dOt[dd * BQ + ty * 4]);
      const float4 kk = *reinterpret_cast<const float4*>(&Kt[dd * BK + tx * 4]);
      const float4 vv = *reinterpret_cast<const float4*>(&Vt[dd * BK + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float gv[4] = {g.x, g.y, g.z, g.w};
      const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
      const float vw[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(av[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vw[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx * 4 + j;
        const bool vis = row < A.sq && kp < A.skv && A.visible(row, kp);
        const float p = expf(s[i][j] - m[i]) / l[i];
        St[(tx * 4 + j) * BQ + ty * 4 + i] = vis ? p * (dp[i][j] - di[i])
                                                 : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(&St[kk * BQ + ty * 4]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
      const float* krow = Ks + kk * D + tx * DC;
      float kv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = krow[c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= A.sq) continue;
    T* orow = dq + ((long long)blockIdx.y * A.sq + row) * D + tx * DC;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[c] = from_f<T>(acc[i][c] * A.scale);
  }
}

// dk and dv per (batch * key/value head, key tile), summing the group's
// query heads inside the block.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
fa_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           T* __restrict__ dk, T* __restrict__ dv,
           const float* __restrict__ stats, const float* __restrict__ di,
           Attn A, int batch) {
  constexpr int DC = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;                       // [D][BK]
  float* Vt = Kt + D * BK;                // [D][BK]
  float* Qt = Vt + D * BK;                // [D][BQ], scaled
  float* dOt = Qt + D * BQ;               // [D][BQ]
  float* Ps = dOt + D * BQ;               // [BQ][BK]
  float* dSs = Ps + BQ * BK;              // [BQ][BK]
  float* Ms = dSs + BQ * BK;              // [BQ] each: m, l, Di
  float* Ls = Ms + BQ;
  float* Dis = Ls + BQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.y / A.hkv, hk = blockIdx.y % A.hkv;
  const int k0 = blockIdx.x * BK, k1 = min(k0 + BK, A.skv) - 1;
  const long long n = (long long)batch * A.hq * A.sq;
  stage_t<T, D, BK>(Kt, k + b * A.ks[0] + hk * A.ks[1], A.ks[2], k0, A.skv,
                    1.0f);
  stage_t<T, D, BK>(Vt, v + b * A.vs[0] + hk * A.vs[1], A.vs[2], k0, A.skv,
                    1.0f);

  float acc_k[DC][4], acc_v[DC][4];
#pragma unroll
  for (int c = 0; c < DC; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc_k[c][j] = 0.0f;
      acc_v[c][j] = 0.0f;
    }
  const int n_qt = (A.sq + BQ - 1) / BQ;
  for (int g = 0; g < A.group; ++g) {
    const int h = hk * A.group + g;
    const T* qb = q + b * A.qs[0] + h * A.qs[1];
    const T* db = dout + b * A.ds[0] + h * A.ds[1];
    const long long sbase = ((long long)b * A.hq + h) * A.sq;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      if (!A.tile_live(q0, min(q0 + BQ, A.sq) - 1, k0, k1)) continue;
      __syncthreads();                   // the last tile's operands are read
      stage_t<T, D, BQ>(Qt, qb, A.qs[2], q0, A.sq, A.scale);
      stage_t<T, D, BQ>(dOt, db, A.ds[2], q0, A.sq, 1.0f);
      if (tid < BQ) {
        const bool in = q0 + tid < A.sq;
        const long long idx = sbase + q0 + tid;
        Ms[tid] = in ? stats[idx] : 0.0f;
        Ls[tid] = in ? stats[n + idx] : 1.0f;
        Dis[tid] = in ? di[idx] : 0.0f;
      }
      __syncthreads();
      float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 4
      for (int dd = 0; dd < D; ++dd) {
        const float4 a =
            *reinterpret_cast<const float4*>(&Qt[dd * BQ + ty * 4]);
        const float4 gg =
            *reinterpret_cast<const float4*>(&dOt[dd * BQ + ty * 4]);
        const float4 kk =
            *reinterpret_cast<const float4*>(&Kt[dd * BK + tx * 4]);
        const float4 vv =
            *reinterpret_cast<const float4*>(&Vt[dd * BK + tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float gv[4] = {gg.x, gg.y, gg.z, gg.w};
        const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
        const float vw[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(av[i], kv[j], s[i][j]);
            dp[i][j] = fmaf(gv[i], vw[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i, row = q0 + r;
        float pr[4], dr[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kp = k0 + tx * 4 + j;
          const bool real = row < A.sq && kp < A.skv;
          const bool vis = real && A.visible(row, kp);
          // a masked score is -1e30: P is 0 there unless the row sees no
          // key at all, where it is 1/Skv as in the forward
          const float p = real ? expf((vis ? s[i][j] : MASKED) - Ms[r]) / Ls[r]
                               : 0.0f;
          pr[j] = p;
          dr[j] = vis ? p * (dp[i][j] - Dis[r]) : 0.0f;
        }
        *reinterpret_cast<float4*>(&Ps[r * BK + tx * 4]) =
            make_float4(pr[0], pr[1], pr[2], pr[3]);
        *reinterpret_cast<float4*>(&dSs[r * BK + tx * 4]) =
            make_float4(dr[0], dr[1], dr[2], dr[3]);
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(&Ps[r * BK + tx * 4]);
        const float4 s4 =
            *reinterpret_cast<const float4*>(&dSs[r * BK + tx * 4]);
        const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const int col = ty * DC + c;
          const float qv = Qt[col * BQ + r], gv = dOt[col * BQ + r];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc_v[c][j] = fmaf(pv[j], gv, acc_v[c][j]);
            acc_k[c][j] = fmaf(sv[j], qv, acc_k[c][j]);
          }
        }
      }
    }
  }

  const long long base = (long long)blockIdx.y * A.skv;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int kp = k0 + tx * 4 + j;
    if (kp >= A.skv) continue;
    T* krow = dk + (base + kp) * D + ty * DC;
    T* vrow = dv + (base + kp) * D + ty * DC;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      krow[c] = from_f<T>(acc_k[c][j]);
      vrow[c] = from_f<T>(acc_v[c][j]);
    }
  }
}

template <int D>
constexpr size_t dq_smem() {
  return (size_t)(4 * D * BQ + BK * D + BK * BQ + BQ) * sizeof(float);
}
template <int D>
constexpr size_t dkv_smem() {
  return (size_t)(4 * D * BQ + 2 * BQ * BK + 3 * BQ) * sizeof(float);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv,
           const float* stats, float* di, int b, const Attn& A,
           cudaStream_t stream) {
  static_assert(BQ == BK, "the shared-memory layouts assume BQ == BK");
  // per device and cheap, so set on every launch
  cudaError_t e = cudaFuncSetAttribute(
      fa_bwd_dq<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dq_smem<D>());
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(fa_bwd_dkv<T, D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)dkv_smem<D>());
  if (e != cudaSuccess) return (int)e;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dt = static_cast<const T*>(dout);
  fa_bwd_dq<T, D><<<dim3((A.sq + BQ - 1) / BQ, b * A.hq), NT, dq_smem<D>(),
                    stream>>>(qt, kt, vt, static_cast<const T*>(o), dt,
                              static_cast<T*>(dq), stats, di, A);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fa_bwd_dkv<T, D><<<dim3((A.skv + BK - 1) / BK, b * A.hkv), NT,
                     dkv_smem<D>(), stream>>>(
      qt, kt, vt, dt, static_cast<T*>(dk), static_cast<T*>(dv), stats, di,
      A, b);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v,
             const void* o, const void* dout, void* dq, void* dk, void* dv,
             const float* st, float* di, int b, const Attn& A,
             cudaStream_t s) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, o, dout, dq, dk, dv, st, di, b, A, s);
    case 32:
      return launch<T, 32>(q, k, v, o, dout, dq, dk, dv, st, di, b, A, s);
    case 64:
      return launch<T, 64>(q, k, v, o, dout, dq, dk, dv, st, di, b, A, s);
    case 112:
      return launch<T, 112>(q, k, v, o, dout, dq, dk, dv, st, di, b, A, s);
    case 128:
      return launch<T, 128>(q, k, v, o, dout, dq, dk, dv, st, di, b, A, s);
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
// b * hq * sq.  window <= 0 means no window.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, const void* stats,
    void* di, int b, int hq, int hkv, int sq, int skv, int d,
    const long long* strides, int causal, int window, float scale, int dtype,
    void* stream_ptr) {
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
                           stream);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(d, q, k, v, o, dout, dq, dk, dv, st, dd, b,
                                   A, stream);
  return (int)cudaErrorInvalidValue;
}

// Name of a CUDA error code, for the wrapper's exception text.
extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
