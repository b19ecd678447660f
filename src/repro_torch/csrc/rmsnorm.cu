// Fused RMSNorm for Hopper (sm_90a): y = x * (mean(x^2) + eps)^-1/2 * w over
// the last dimension, with the mean and the products in float32 and the
// result cast back to the dtype of x (float32 or bfloat16).
//
// Replaces the Pallas TPU kernel `_rms_kernel`, launched by `rmsnorm`
// (src/repro/kernels/rmsnorm/kernel.py).  Plain version:
// src/repro_torch/kernels/rmsnorm/ref.py.  Binding and launch plan:
// src/repro_torch/kernels/rmsnorm/kernel.py (ctypes).
//
// What bounds it.  It reads each element of x once and writes each output
// once, with about four float operations per element: far below the card's
// 295 operations per byte, so it is bound by device memory (3.35 TB/s on an
// H100 SXM).  Reaching that rate takes three things: 16-byte loads and
// stores, enough bytes in flight on every SM to cover the memory latency,
// and one read of each row from device memory.
//
// Design (`rmsnorm_rows`).  A group of `tpr` threads owns a row and each
// thread keeps its VPT 16-byte vectors of the row in registers from the sum
// of squares through to the store, so x is read once.  The launch plan
// (threads per row, vectors per thread, rows a group, block, grid) is
// computed in Python from d, the dtype, the row count and alignment, and
// chosen by measurement on an H100 (PERF.md):
//   - Rows of up to 32 vectors (the head-dim rows of 128 that q_norm and
//     k_norm see): `tpr` is a power of two up to 32 (16 for 128 bf16), so a
//     warp holds several rows, reduced with __shfl_xor_sync inside the
//     group; each group holds U = 2 rows.  A grid of one wave walks tiles
//     of rows: each thread loads the weight once and keeps it in
//     registers, and loads its next tile before it reduces this one, so it
//     has two tiles' loads in flight.
//   - Wider rows (the d_model rows of 5120): `tpr` is a multiple of 32 and
//     VPT up to 8, the split even with VPT near 4 (640 bf16 vectors: 160
//     threads x 4), one row a block; warp shuffles, then one shared-memory
//     step across the row's warps.  What bounds it is rows in flight per
//     SM, so the block holds nothing it does not need while its loads are
//     out: the weight is read (from L1/L2) after the reduction.  A walking
//     grid that loads the next row ahead was slower here: its second buffer
//     and weight registers cost blocks per SM.
// Rows may sit at strides: row r of a view with nested row sizes
// (n0, n1, n2) and strides (s0, s1, s2) starts at i0*s0 + i1*s1 + i2*s2, so
// the transposed heads view (B, H, S, D) is read in place; the output is
// contiguous in row order.  The ragged row count is masked, never padded.
//
// The scalar path (`rmsnorm_loop`) takes unaligned pointers, strides or
// widths, one element per load, and rows too wide for a thread's registers:
// a group of threads walks the row twice, the second pass reading it back
// from L1/L2.
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
__device__ __forceinline__ Pack<T, VEC> zero_pack() {
  Pack<T, VEC> p;
#pragma unroll
  for (int j = 0; j < VEC; ++j) p.v[j] = from_f<T>(0.0f);
  return p;
}

// The rows of x and where each starts; `small` when every row index fits
// 32 bits, so the index split takes 32-bit divisions.
struct Layout {
  long long n_rows, n1, n2, s0, s1, s2;
  int d;
  float eps;
  bool small;

  __device__ __forceinline__ long long offset(long long row) const {
    if (small) {
      unsigned r = (unsigned)row;
      const unsigned i2 = r % (unsigned)n2;
      r /= (unsigned)n2;
      return (long long)(r / (unsigned)n1) * s0 +
             (long long)(r % (unsigned)n1) * s1 + (long long)i2 * s2;
    }
    const long long i2 = row % n2, r = row / n2;
    return (r / n1) * s0 + (r % n1) * s1 + i2 * s2;
  }
};

// Tiles of `groups * U` rows; group g of a block holds rows
// t * groups * U + u * groups + g for u < U.  WALK: a grid of one wave
// walks the tiles, loading the next tile before it reduces this one; else
// one block per tile, with no second buffer and no weight registers.
template <typename T, int VEC, int VPT, int U, bool WALK>
__global__ void __launch_bounds__(512) rmsnorm_rows(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
    Layout L, int tpr) {
  using P = Pack<T, VEC>;
  __shared__ float red[2][U][16];          // per warp, double-buffered
  const int nv = L.d / VEC;
  const int groups = blockDim.x / tpr;
  const int g = threadIdx.x / tpr;
  const int lane = threadIdx.x % tpr;
  const long long per_tile = (long long)groups * U;
  const long long n_tiles = (L.n_rows + per_tile - 1) / per_tile;

  // walking blocks keep the weight in registers across their rows; a block
  // of one row reads it after the reduction, so that its registers are free
  // while the row's loads are in flight
  const P* wr = reinterpret_cast<const P*>(w);
  P wv[VPT];
  if constexpr (WALK) {
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int v = lane + k * tpr;
      wv[k] = v < nv ? wr[v] : zero_pack<T, VEC>();
    }
  }

  P cur[U][VPT], nxt[U][VPT];
  auto load_tile = [&](long long t, P (&buf)[U][VPT]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long row = t * per_tile + u * groups + g;
      const P* xr = row < L.n_rows
          ? reinterpret_cast<const P*>(x + L.offset(row)) : nullptr;
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        const int v = lane + k * tpr;
        buf[u][k] = (xr && v < nv) ? xr[v] : zero_pack<T, VEC>();
      }
    }
  };

  long long t = blockIdx.x;
  if (WALK && t < n_tiles) load_tile(t, cur);
  for (int parity = 0; t < n_tiles; t += gridDim.x, parity ^= 1) {
    if constexpr (WALK) {
      if (t + gridDim.x < n_tiles) load_tile(t + gridDim.x, nxt);
    } else {
      load_tile(t, cur);
    }

    float ss[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ss[u] = 0.0f;
#pragma unroll
      for (int k = 0; k < VPT; ++k)
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float f = to_f(cur[u][k].v[j]);
          ss[u] = fmaf(f, f, ss[u]);
        }
    }
    const int width = tpr < 32 ? tpr : 32;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      if (o < width)
#pragma unroll
        for (int u = 0; u < U; ++u)
          ss[u] += __shfl_xor_sync(0xffffffffu, ss[u], o);
    if (tpr > 32) {                        // the row spans several warps
      const int wpr = tpr / 32;
      if ((threadIdx.x & 31) == 0)
#pragma unroll
        for (int u = 0; u < U; ++u) red[parity][u][threadIdx.x / 32] = ss[u];
      __syncthreads();
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float s = 0.0f;
        for (int i = 0; i < wpr; ++i) s += red[parity][u][g * wpr + i];
        ss[u] = s;
      }
    }

#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long row = t * per_tile + u * groups + g;
      if (row >= L.n_rows) continue;
      const float inv = 1.0f / sqrtf(ss[u] / (float)L.d + L.eps);
      P* orow = reinterpret_cast<P*>(out + row * (long long)L.d);
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        const int v = lane + k * tpr;
        if (v >= nv) continue;
        const P wk = WALK ? wv[k] : wr[v];
        P o;
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          o.v[j] = from_f<T>((to_f(cur[u][k].v[j]) * inv) * to_f(wk.v[j]));
        orow[v] = o;
      }
    }
    if constexpr (WALK) {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int k = 0; k < VPT; ++k) cur[u][k] = nxt[u][k];
    }
  }
}

// The scalar path: `tpr` threads per row, `blockDim.x / tpr` rows a block,
// one block per group of rows; the row is read twice.
template <typename T, int VEC>
__global__ void rmsnorm_loop(const T* __restrict__ x,
                             const T* __restrict__ w, T* __restrict__ out,
                             Layout L, int tpr) {
  __shared__ float red[32];
  using P = Pack<T, VEC>;
  const int rows_per_block = blockDim.x / tpr;
  const int sub = threadIdx.x / tpr;       // the block's row this thread has
  const int lane = threadIdx.x % tpr;      // this thread's place in its row
  const long long row = (long long)blockIdx.x * rows_per_block + sub;
  const bool live = row < L.n_rows;
  const int nv = L.d / VEC;

  const P* xr = nullptr;
  float ss = 0.0f;
  if (live) {
    xr = reinterpret_cast<const P*>(x + L.offset(row));
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
  if (tpr > 32) {
    const int wpr = tpr / 32;
    if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = ss;
    __syncthreads();
    ss = 0.0f;
    for (int i = 0; i < wpr; ++i) ss += red[sub * wpr + i];
  }
  if (!live) return;

  const float inv = 1.0f / sqrtf(ss / (float)L.d + L.eps);
  const P* wr = reinterpret_cast<const P*>(w);
  P* orow = reinterpret_cast<P*>(out + row * (long long)L.d);
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

template <typename T>
using Kernel = void (*)(const T*, const T*, T*, Layout, int);

template <typename T, int V>
Kernel<T> select_vpt(int vpt) {
  switch (vpt) {
    case 1: return rmsnorm_rows<T, V, 1, 1, false>;
    case 2: return rmsnorm_rows<T, V, 2, 1, false>;
    case 3: return rmsnorm_rows<T, V, 3, 1, false>;
    case 4: return rmsnorm_rows<T, V, 4, 1, false>;
    case 5: return rmsnorm_rows<T, V, 5, 1, false>;
    case 6: return rmsnorm_rows<T, V, 6, 1, false>;
    case 7: return rmsnorm_rows<T, V, 7, 1, false>;
    case 8: return rmsnorm_rows<T, V, 8, 1, false>;
    default: return nullptr;
  }
}

// The instance a plan names, or nullptr: the plans are narrow rows (one
// vector a thread, two rows a group, walking) and wide rows (one row a
// group and a block).
template <typename T>
Kernel<T> select(int kind, int vec, int vpt, int rows_per_group, int walk) {
  constexpr int V = 16 / sizeof(T);        // elements in 16 bytes
  if (kind == 1) {
    if (vec == 1) return rmsnorm_loop<T, 1>;
    if (vec == V) return rmsnorm_loop<T, V>;
    return nullptr;
  }
  if (kind != 0 || vec != V) return nullptr;
  if (vpt == 1 && rows_per_group == 2 && walk)
    return rmsnorm_rows<T, V, 1, 2, true>;
  if (rows_per_group == 1 && !walk) return select_vpt<T, V>(vpt);
  return nullptr;
}

template <typename T>
int launch(const void* x, const void* w, void* out, const Layout& L,
           Kernel<T> k, int tpr, int block, int grid, cudaStream_t s) {
  if (k == nullptr || block > 1024 || tpr <= 0 || block % tpr != 0 ||
      grid <= 0)
    return (int)cudaErrorInvalidValue;
  k<<<grid, block, 0, s>>>(static_cast<const T*>(x),
                           static_cast<const T*>(w), static_cast<T*>(out),
                           L, tpr);
  return (int)cudaGetLastError();
}

template <typename T>
int occupancy(Kernel<T> k, int block, int* blocks_per_sm) {
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, (const void*)k, block, 0);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); never synchronises
// and allocates nothing.  dtype 0 is float32, 1 bfloat16 (x, w and out all
// of it); `out` is (n_rows, d) contiguous; x's rows are laid out as the
// header says; `w` is (d,) contiguous.  The plan comes from the wrapper's
// launch_plan: kind 0 is rmsnorm_rows, 1 rmsnorm_loop; `vec` elements per
// load, `tpr` threads per row, `vpt` vectors per thread, `rows_per_group`
// rows a group holds at once, `walk` for a grid that walks the tiles (and
// loads ahead), `block` threads and `grid` blocks.
extern "C" int rmsnorm_launch(const void* x, const void* w, void* out,
                              long long n_rows, int d, long long n1,
                              long long n2, long long s0, long long s1,
                              long long s2, float eps, int dtype, int kind,
                              int vec, int tpr, int vpt, int rows_per_group,
                              int walk, int block, int grid,
                              void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const Layout L{n_rows, n1, n2, s0, s1, s2, d, eps,
                 n_rows <= (long long)UINT32_MAX};
  if (dtype == 0)
    return launch<float>(x, w, out, L,
                         select<float>(kind, vec, vpt, rows_per_group, walk),
                         tpr, block, grid, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(
        x, w, out, L,
        select<__nv_bfloat16>(kind, vec, vpt, rows_per_group, walk), tpr,
        block, grid, stream);
  return (int)cudaErrorInvalidValue;
}

// The blocks of `block` threads of the planned instance one SM holds at
// once, for the wrapper's grid.
extern "C" int rmsnorm_blocks_per_sm(int dtype, int kind, int vec, int vpt,
                                     int rows_per_group, int walk, int block,
                                     int* blocks_per_sm) {
  if (dtype == 0)
    return occupancy<float>(
        select<float>(kind, vec, vpt, rows_per_group, walk), block,
        blocks_per_sm);
  if (dtype == 1)
    return occupancy<__nv_bfloat16>(
        select<__nv_bfloat16>(kind, vec, vpt, rows_per_group, walk), block,
        blocks_per_sm);
  return (int)cudaErrorInvalidValue;
}

// Name of a CUDA error code, for the wrapper's exception text.
extern "C" const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
