// Flash attention for Hopper (sm_90a): blockwise online-softmax attention
// with grouped-query heads, a causal mask aligned at the sequence ends and an
// optional sliding window, in float32 or bfloat16.
//
// Replaces the Pallas TPU kernel `_fa_kernel`, launched by `flash_attention`
// (src/repro/kernels/flash_attention/kernel.py).  Plain version:
// src/repro_torch/kernels/flash_attention/ref.py.  Binding:
// src/repro_torch/kernels/flash_attention/kernel.py (ctypes).
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
// as ref.py gives; the Pallas kernel gave 0 there.
//
// What bounds it.  At the prefill shape the work is 4 * D operations per
// visible (query, key) pair, 687 GFLOP for q (4, 40, 4096, 128) causal,
// against 0.40 GB of inputs and outputs: bound by operations.  This kernel
// does them as float32 FMAs outside the tensor cores (67 TFLOP/s at most),
// as the TPU kernel's float32 dot_general does, so it cannot come near the
// bfloat16 tensor-core bound (989 TFLOP/s).  The binding therefore sends
// bfloat16 at D 64, 112 and 128, the main path, to the tensor-core kernel of
// csrc/flash_attention_wgmma.cu; this one serves float32 (D 16, 32, 64, 112
// and 128) and bfloat16 at D 16 and 32.
//
// Design.  One block of 256 threads per (batch * query head, 64-row query
// tile); the heaviest causal tiles launch first.  A loop inside the block over
// 64-key tiles takes the place of the TPU's sequential fori_loop and stops at
// the causal bound; with a window it also starts at the window's first tile.
// Shared memory holds, in float32, the scaled query tile transposed
// (Qt[d][row]), the key tile transposed (Kt[d][key]), the value tile
// (Vs[key][d]) and the probabilities transposed (Pt[key][row]): 112 KB at
// D = 128, 100 KB at D = 112.  Thread (ty, tx) of a 16 x 16 grid owns score
// rows 4ty..4ty+3 and columns 4tx..4tx+3, and output rows 4ty..4ty+3 and
// columns tx*D/16..(tx+1)*D/16-1 (7 columns at D = 112, read from Vs one at
// a time), so a row's running max, denominator and
// accumulator stay in the registers of the 16 threads that share ty; row
// reductions are 16-lane shuffles.  Loads are 16 bytes a thread; the ragged
// ends of Sq and Skv are masked in the kernel (keys past Skv count as absent,
// not as masked), so no length needs to divide 64.  When the caller passes a
// `stats` buffer (autograd's forward) the epilogue also writes each row's
// max m and sum l, the row statistics the backward
// (csrc/flash_attention_bwd.cu) reads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BQ = 64;        // query rows per block
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
__device__ __forceinline__ void load_row_chunk(const T* p, bool live,
                                               float* f) {
  if (live) {
    const Pack<T, VEC> pk = *reinterpret_cast<const Pack<T, VEC>*>(p);
#pragma unroll
    for (int j = 0; j < VEC; ++j) f[j] = to_f(pk.v[j]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) f[j] = 0.0f;
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

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ stats, int hq, int group, int sq,
                       int skv, long long qsb,
                       long long qsh, long long qss, long long ksb,
                       long long ksh, long long kss, long long vsb,
                       long long vsh, long long vss, int causal, int window,
                       float scale) {
  constexpr int VEC = 16 / sizeof(T);     // elements in one 16-byte load
  constexpr int CH = D / VEC;             // 16-byte chunks in a row
  constexpr int DC = D / 16;              // output columns per thread
  extern __shared__ float smem[];
  float* Qt = smem;                       // [D][BQ]
  float* Kt = Qt + D * BQ;                // [D][BK]
  float* Vs = Kt + D * BK;                // [BK][D]
  float* Pt = Vs + BK * D;                // [BK][BQ]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest tiles first
  const int b = blockIdx.y / hq, h = blockIdx.y % hq, hk = h / group;
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

  for (int i = tid; i < BQ * CH; i += NT) {
    const int r = i % BQ, c = i / BQ;
    float f[VEC];
    load_row_chunk<T, VEC>(qb + (long long)(q0 + r) * qss + c * VEC,
                           q0 + r < sq, f);
#pragma unroll
    for (int j = 0; j < VEC; ++j) Qt[(c * VEC + j) * BQ + r] = f[j] * scale;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = MASKED;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.0f;
  }

  for (int t = lo; t < hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();                 // the last tile's Kt, Vs, Pt are read
    for (int i = tid; i < BK * CH; i += NT) {
      const int r = i % BK, c = i / BK;
      float f[VEC];
      load_row_chunk<T, VEC>(kb + (long long)(k0 + r) * kss + c * VEC,
                             k0 + r < skv, f);
#pragma unroll
      for (int j = 0; j < VEC; ++j) Kt[(c * VEC + j) * BK + r] = f[j];
    }
    for (int i = tid; i < BK * CH; i += NT) {
      const int r = i / CH, c = i % CH;
      float f[VEC];
      load_row_chunk<T, VEC>(vb + (long long)(k0 + r) * vss + c * VEC,
                             k0 + r < skv, f);
#pragma unroll
      for (int j = 0; j < VEC; ++j) Vs[r * D + c * VEC + j] = f[j];
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int dd = 0; dd < D; ++dd) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[dd * BQ + ty * 4]);
      const float4 kk =
          *reinterpret_cast<const float4*>(&Kt[dd * BK + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q0 + ty * 4 + i + off;
      float mx = MASKED;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + tx * 4 + j;
        if (k_pos >= skv)
          s[i][j] = -CUDART_INF_F;       // not a key: contributes nothing
        else if ((causal && k_pos > q_pos) ||
                 (window > 0 && k_pos <= q_pos - window))
          s[i][j] = MASKED;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row16_max(mx));   // finite
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Pt[(tx * 4 + j) * BQ + ty * 4 + i] = p;
      }
      l[i] = l[i] * alpha + row16_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(&Pt[kk * BQ + ty * 4]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
      float vv[DC];
      const float* vrow = Vs + kk * D + tx * DC;
      if constexpr (DC % 4 == 0) {
#pragma unroll
        for (int c = 0; c < DC; c += 4) {
          const float4 x4 = *reinterpret_cast<const float4*>(vrow + c);
          vv[c] = x4.x;
          vv[c + 1] = x4.y;
          vv[c + 2] = x4.z;
          vv[c + 3] = x4.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < DC; ++c) vv[c] = vrow[c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    const float denom = l[i] == 0.0f ? 1.0f : l[i];
    if (stats != nullptr && tx == 0) {
      const long long idx = (long long)blockIdx.y * sq + row;
      stats[idx] = m[i];
      stats[(long long)gridDim.y * sq + idx] = l[i];
    }
    T* orow = out + ((long long)blockIdx.y * sq + row) * D + tx * DC;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[c] = from_f<T>(acc[i][c] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out,
           float* stats, int b, int hq, int hkv, int sq, int skv,
           const long long* st, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = (size_t)(3 * D * BQ + BK * BQ) * sizeof(float);
  static_assert(BQ == BK, "the shared-memory layout assumes BQ == BK");
  // per device and cheap, so set on every launch
  const cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((sq + BQ - 1) / BQ, b * hq);
  flash_attention_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), stats, hq, hq / hkv,
      sq, skv,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal,
      window, scale);
  return (int)cudaGetLastError();
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
// all of it); d is 16, 32, 64, 112 or 128.  `strides` holds the element strides
// of q, k and v over (batch, head, position), in that order, nine in all;
// the last dimension is contiguous and every row 16-byte aligned.  `out` is
// (b, hq, sq, d) contiguous.  `stats` is null, or float32 (2, b, hq, sq)
// that receives each row's m and l.  window <= 0 means no window.
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

// Name of a CUDA error code, for the wrapper's exception text.
extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
