// Fused RMSNorm for Hopper (sm_90a): y = x * (mean(x^2) + eps)^-1/2 * w over
// the last dimension, with the mean and the products in float32 and the
// result cast back to the dtype of x (float32 or bfloat16).
//
// Replaces the Pallas TPU kernel `_rms_kernel`, launched by `rmsnorm`
// (src/repro/kernels/rmsnorm/kernel.py).  Plain version:
// src/repro_torch/kernels/rmsnorm/ref.py.  Binding:
// src/repro_torch/kernels/rmsnorm/kernel.py (ctypes).
//
// What bounds it.  It reads each element of x once and writes each output
// once, with about four float operations per element: far below the card's
// 295 operations per byte, so it is bound by device memory (3.35 TB/s on an
// H100 SXM).  The design keeps to one read of x from device memory and one
// write: the second pass over a row reads it back from L1/L2, where the
// first pass left it (a row is at most a few tens of KB).
//
// Design.  A row is owned by `tpr` threads: one warp for narrow rows (the
// head-dim rows of width 128 that q_norm and k_norm see, eight rows to a
// block of 256) and a whole block for wide ones (the d_model rows of width
// 5120, one row to a block).  Loads and stores are 16 bytes a thread (8
// bfloat16 or 4 float32) when every pointer and stride allows, else one
// element.  The sum of squares is reduced with warp shuffles, then across the
// row's warps in shared memory.  The ragged row count is masked, never
// padded.  Rows may sit at strides: row r of a view with nested row sizes
// (n0, n1, n2) and strides (s0, s1, s2) starts at i0*s0 + i1*s1 + i2*s2, so
// the transposed heads view (B, H, S, D) is read in place; the output is
// contiguous in row order.
//
// Numerics.  The inverse root is 1.0f / sqrtf(var + eps), both correctly
// rounded (no fast math), not rsqrtf, which is not; the product is
// (x * inv) * w in that order, as ref.py multiplies.  Only the order of the
// sum of squares differs from the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <typename T, int VEC>
__global__ void rmsnorm_kernel(const T* __restrict__ x,
                               const T* __restrict__ w, T* __restrict__ out,
                               long long n_rows, int d, long long n1,
                               long long n2, long long s0, long long s1,
                               long long s2, float eps, int tpr) {
  __shared__ float red[32];
  using P = Pack<T, VEC>;
  const int rows_per_block = blockDim.x / tpr;
  const int sub = threadIdx.x / tpr;       // the block's row this thread has
  const int lane = threadIdx.x % tpr;      // this thread's place in its row
  const long long row = (long long)blockIdx.x * rows_per_block + sub;
  const bool live = row < n_rows;
  const int nv = d / VEC;

  const P* xr = nullptr;
  float ss = 0.0f;
  if (live) {
    const long long i2 = row % n2, r = row / n2;
    const long long i1 = r % n1, i0 = r / n1;
    xr = reinterpret_cast<const P*>(x + i0 * s0 + i1 * s1 + i2 * s2);
    for (int v = lane; v < nv; v += tpr) {
      const P p = xr[v];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float f = to_f(p.v[j]);
        ss = fmaf(f, f, ss);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (tpr > 32) {                          // the row spans several warps
    const int wpr = tpr / 32;
    if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = ss;
    __syncthreads();
    ss = 0.0f;
    for (int i = 0; i < wpr; ++i) ss += red[sub * wpr + i];
  }
  if (!live) return;

  const float inv = 1.0f / sqrtf(ss / (float)d + eps);
  const P* wr = reinterpret_cast<const P*>(w);
  P* orow = reinterpret_cast<P*>(out + row * (long long)d);
  for (int v = lane; v < nv; v += tpr) {
    const P p = xr[v];
    const P wp = wr[v];
    P o;
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      o.v[j] = from_f<T>((to_f(p.v[j]) * inv) * to_f(wp.v[j]));
    orow[v] = o;
  }
}

template <typename T, int VEC>
int launch(const void* x, const void* w, void* out, long long n_rows, int d,
           long long n1, long long n2, long long s0, long long s1,
           long long s2, float eps, cudaStream_t stream) {
  const int nv = d / VEC;
  // threads per row: a warp up to 128 vectors, else a power of two near a
  // quarter of the row's vectors, at most 1024
  int tpr = 32;
  while (tpr < 1024 && tpr * 4 < nv) tpr *= 2;
  const int block = tpr < 256 ? 256 : tpr;
  const long long rows_per_block = block / tpr;
  const long long grid = (n_rows + rows_per_block - 1) / rows_per_block;
  rmsnorm_kernel<T, VEC><<<(unsigned)grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), n_rows, d, n1, n2, s0, s1, s2, eps, tpr);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); never synchronises
// and allocates nothing.  dtype 0 is float32, 1 bfloat16 (x, w and out all
// of it); `out` is (n_rows, d) contiguous; x's rows are laid out as the
// header says; `w` is (d,) contiguous.
extern "C" int rmsnorm_launch(const void* x, const void* w, void* out,
                              long long n_rows, int d, long long n1,
                              long long n2, long long s0, long long s1,
                              long long s2, float eps, int dtype,
                              void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int vec = dtype == 0 ? 4 : 8;      // elements in 16 bytes
  const bool wide = aligned16(x) && aligned16(w) && aligned16(out) &&
                    d % vec == 0 && s0 % vec == 0 && s1 % vec == 0 &&
                    s2 % vec == 0;
  if (dtype == 0)
    return wide ? launch<float, 4>(x, w, out, n_rows, d, n1, n2, s0, s1, s2,
                                   eps, stream)
                : launch<float, 1>(x, w, out, n_rows, d, n1, n2, s0, s1, s2,
                                   eps, stream);
  if (dtype == 1)
    return wide ? launch<__nv_bfloat16, 8>(x, w, out, n_rows, d, n1, n2, s0,
                                           s1, s2, eps, stream)
                : launch<__nv_bfloat16, 1>(x, w, out, n_rows, d, n1, n2, s0,
                                           s1, s2, eps, stream);
  return (int)cudaErrorInvalidValue;
}

// Name of a CUDA error code, for the wrapper's exception text.
extern "C" const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
