// Fused RMSNorm for Hopper (sm_90a), forward and backward: y = x * (mean(x^2)
// + eps)^-1/2 * w over the last dimension, with the mean and the products in
// float32 and the result cast back to the dtype of x (float32 or bfloat16).
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
//
// The backward (`rmsnorm_bwd_*`, below the forward): given x, the weight w
// and the output's gradient dy over rows of d, with r = sqrt(mean(x^2) + eps),
//   dx = (w * dy) / r - x * sum(w * dy * x) / (d * r^3)
//   dw = sum over rows of dy * x / r
// in float32, returned in the dtype of x (float32 or bfloat16).
//
// The JAX package has no backward Pallas kernel: it trains through the
// plain jnp RMSNorm (`repro/models/layers.py`, impl="ref"), so this kernel
// is held against `jax.vjp` of that plain version and against autograd
// through the port's plain version (src/repro_torch/kernels/rmsnorm/ref.py,
// whose `rmsnorm_bwd` is the same formula).  Launch plan: `bwd_plan` in
// src/repro_torch/kernels/rmsnorm/kernel.py.
//
// What bounds it.  It reads x and dy once and writes dx once, with about ten
// float operations per element: bound by device memory.  dw is a sum over
// every row, which on a GPU is a reduction across blocks.
//
// Design.  Two launches, so that dw is deterministic (no float atomics):
//   - `rmsnorm_bwd_rows`: a grid of as many 256-thread blocks as the SMs
//     hold walks tiles of rows.  A group of `tpr` threads owns a row and
//     each thread keeps its MAXV 16-byte vectors of x, dy and w in registers
//     from the two row sums through to the store of dx, so each is read
//     once; the group reduces with warp shuffles (and one shared-memory
//     step when the row spans warps).  Each thread also keeps its columns'
//     share of dw in float32 registers across every row the block visits;
//     at the end the block's groups add theirs in a fixed order and the
//     block writes one partial row of dw (grid x d, float32).
//   - `rmsnorm_bwd_dw`: one thread per column sums the partial rows in
//     order and rounds once to the dtype of x.
// Rows too wide for MAXV (or unaligned rows wider than the scalar plan)
// take `rmsnorm_bwd_loop`: one row a block at a time, read twice, each
// column of the partial row owned by one thread of the block.  Rows of x
// and dy may each sit at their own strides (three nested row dimensions, as
// in the forward kernel), so q_norm's and k_norm's heads views (B, H, S, D)
// are read in place; dx is contiguous in row order.

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

// ---------------------------------------------------------------- backward

namespace {

constexpr int BLOCK = 256;            // threads of a backward block

// Where each row of a tensor starts: row r = (i0 * n1 + i1) * n2 + i2 starts
// at i0 * s0 + i1 * s1 + i2 * s2 elements.
struct Rows {
  long long n1, n2, s0, s1, s2;

  __device__ __forceinline__ long long offset(long long row) const {
    const long long i2 = row % n2, r = row / n2;
    return (r / n1) * s0 + (r % n1) * s1 + i2 * s2;
  }
};

struct Shape {
  long long n_rows;
  int d;
  float eps;
};

// The two row sums, reduced over the row's group of `tpr` threads.  Every
// thread of the block calls it the same number of times.
__device__ __forceinline__ void group_sum2(float& a, float& b, int tpr,
                                           float (*red)[BLOCK / 32]) {
  const int width = tpr < 32 ? tpr : 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    if (o < width) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
  if (tpr > 32) {
    const int wpr = tpr / 32, warp = threadIdx.x / 32;
    const int first = warp / wpr * wpr;
    __syncthreads();                       // the last row's reads are done
    if ((threadIdx.x & 31) == 0) {
      red[0][warp] = a;
      red[1][warp] = b;
    }
    __syncthreads();
    a = 0.0f;
    b = 0.0f;
    for (int i = 0; i < wpr; ++i) {
      a += red[0][first + i];
      b += red[1][first + i];
    }
  }
}

template <typename T, int VEC, int MAXV>
__global__ void __launch_bounds__(BLOCK) rmsnorm_bwd_rows(
    const T* __restrict__ x, const T* __restrict__ w,
    const T* __restrict__ dy, T* __restrict__ dx,
    float* __restrict__ partial, Shape S, Rows Lx, Rows Ld, int tpr) {
  using P = Pack<T, VEC>;
  extern __shared__ float sw[];            // [groups][d] when groups > 1
  __shared__ float red[2][BLOCK / 32];
  const int nv = S.d / VEC;
  const int groups = BLOCK / tpr;
  const int g = threadIdx.x / tpr;
  const int lane = threadIdx.x % tpr;
  const long long n_tiles = (S.n_rows + groups - 1) / groups;

  // x, dy and w stay in registers in their own dtype (half the registers
  // in bfloat16); only dw's share is float32
  P wp[MAXV];
  float acc[MAXV][VEC];
#pragma unroll
  for (int k = 0; k < MAXV; ++k) {
    const int v = lane + k * tpr;
    wp[k] = v < nv ? reinterpret_cast<const P*>(w)[v] : zero_pack<T, VEC>();
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[k][j] = 0.0f;
  }

  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long row = t * groups + g;
    const bool live = row < S.n_rows;
    const P* xr = live ? reinterpret_cast<const P*>(x + Lx.offset(row))
                       : nullptr;
    const P* dr = live ? reinterpret_cast<const P*>(dy + Ld.offset(row))
                       : nullptr;
    P xp[MAXV], dp[MAXV];
#pragma unroll
    for (int k = 0; k < MAXV; ++k) {
      const int v = lane + k * tpr;
      const bool in = live && v < nv;
      xp[k] = in ? xr[v] : zero_pack<T, VEC>();
      dp[k] = in ? dr[v] : zero_pack<T, VEC>();
    }
    float ss = 0.0f, sgx = 0.0f;
#pragma unroll
    for (int k = 0; k < MAXV; ++k)
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xv = to_f(xp[k].v[j]);
        ss = fmaf(xv, xv, ss);
        sgx = fmaf(to_f(wp[k].v[j]) * to_f(dp[k].v[j]), xv, sgx);
      }
    group_sum2(ss, sgx, tpr, red);
    if (!live) continue;
    const float inv = 1.0f / sqrtf(ss / (float)S.d + S.eps);
    const float c = sgx * inv * inv * inv / (float)S.d;
    P* orow = reinterpret_cast<P*>(dx + row * (long long)S.d);
#pragma unroll
    for (int k = 0; k < MAXV; ++k) {
      const int v = lane + k * tpr;
      if (v >= nv) continue;
      P o;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xv = to_f(xp[k].v[j]), dv = to_f(dp[k].v[j]);
        o.v[j] = from_f<T>(to_f(wp[k].v[j]) * dv * inv - xv * c);
        acc[k][j] = fmaf(dv * xv, inv, acc[k][j]);
      }
      orow[v] = o;
    }
  }

  // the block's partial row of dw: its groups' shares added in group order
  float* prow = partial + (long long)blockIdx.x * S.d;
  if (groups == 1) {
#pragma unroll
    for (int k = 0; k < MAXV; ++k) {
      const int v = lane + k * tpr;
      if (v < nv)
#pragma unroll
        for (int j = 0; j < VEC; ++j) prow[v * VEC + j] = acc[k][j];
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < MAXV; ++k) {
    const int v = lane + k * tpr;
    if (v < nv)
#pragma unroll
      for (int j = 0; j < VEC; ++j) sw[g * S.d + v * VEC + j] = acc[k][j];
  }
  __syncthreads();
  for (int col = threadIdx.x; col < S.d; col += BLOCK) {
    float s = 0.0f;
    for (int i = 0; i < groups; ++i) s += sw[i * S.d + col];
    prow[col] = s;
  }
}

// Rows too wide for the register kernel: one row a block at a time, read
// twice, one element per load; column c of the block's partial row belongs
// to thread c % BLOCK, which adds each row's term in row order.
template <typename T>
__global__ void __launch_bounds__(BLOCK) rmsnorm_bwd_loop(
    const T* __restrict__ x, const T* __restrict__ w,
    const T* __restrict__ dy, T* __restrict__ dx,
    float* __restrict__ partial, Shape S, Rows Lx, Rows Ld) {
  __shared__ float red[2][BLOCK / 32];
  float* prow = partial + (long long)blockIdx.x * S.d;
  for (int c = threadIdx.x; c < S.d; c += BLOCK) prow[c] = 0.0f;
  for (long long row = blockIdx.x; row < S.n_rows; row += gridDim.x) {
    const T* xr = x + Lx.offset(row);
    const T* dr = dy + Ld.offset(row);
    float ss = 0.0f, sgx = 0.0f;
    for (int c = threadIdx.x; c < S.d; c += BLOCK) {
      const float xv = to_f(xr[c]);
      ss = fmaf(xv, xv, ss);
      sgx = fmaf(to_f(w[c]) * to_f(dr[c]), xv, sgx);
    }
    group_sum2(ss, sgx, BLOCK, red);
    const float inv = 1.0f / sqrtf(ss / (float)S.d + S.eps);
    const float k = sgx * inv * inv * inv / (float)S.d;
    T* orow = dx + row * (long long)S.d;
    for (int c = threadIdx.x; c < S.d; c += BLOCK) {
      const float xv = to_f(xr[c]), dv = to_f(dr[c]);
      orow[c] = from_f<T>(to_f(w[c]) * dv * inv - xv * k);
      prow[c] = fmaf(dv * xv, inv, prow[c]);
    }
  }
}

// dw[c] = the sum of the partial rows' column c, in row order.
template <typename T>
__global__ void rmsnorm_bwd_dw(const float* __restrict__ partial, int n_part,
                               int d, T* __restrict__ dw) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float s = 0.0f;
  for (int i = 0; i < n_part; ++i) s += partial[(long long)i * d + c];
  dw[c] = from_f<T>(s);
}

template <typename T>
using RowsKernel = void (*)(const T*, const T*, const T*, T*, float*, Shape,
                            Rows, Rows, int);

// The register kernel for (vec, maxv), or nullptr.
template <typename T>
RowsKernel<T> bwd_select(int vec, int maxv) {
  constexpr int V = 16 / sizeof(T);
  if (vec == V) {
    switch (maxv) {
      case 1: return rmsnorm_bwd_rows<T, V, 1>;
      case 2: return rmsnorm_bwd_rows<T, V, 2>;
      case 4: return rmsnorm_bwd_rows<T, V, 4>;
      case 8: return rmsnorm_bwd_rows<T, V, 8>;
      default: return nullptr;
    }
  }
  if (vec == 1) {
    switch (maxv) {
      case 1: return rmsnorm_bwd_rows<T, 1, 1>;
      case 2: return rmsnorm_bwd_rows<T, 1, 2>;
      case 4: return rmsnorm_bwd_rows<T, 1, 4>;
      case 8: return rmsnorm_bwd_rows<T, 1, 8>;
      default: return nullptr;
    }
  }
  return nullptr;
}

template <typename T>
int bwd_launch(const void* x, const void* w, const void* dy, void* dx,
               void* dw, float* partial, const Shape& S, const Rows& Lx,
               const Rows& Ld, int kind, int vec, int maxv, int tpr, int grid,
               cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  if (kind == 0) {
    RowsKernel<T> k = bwd_select<T>(vec, maxv);
    if (k == nullptr || tpr <= 0 || tpr > BLOCK || BLOCK % tpr != 0 ||
        (long long)tpr * maxv * vec < S.d)
      return (int)cudaErrorInvalidValue;
    const int groups = BLOCK / tpr;
    const size_t smem = groups > 1 ? (size_t)groups * S.d * sizeof(float) : 0;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    k<<<grid, BLOCK, smem, s>>>(xt, wt, dyt, dxt, partial, S, Lx, Ld, tpr);
  } else if (kind == 1) {
    rmsnorm_bwd_loop<T><<<grid, BLOCK, 0, s>>>(xt, wt, dyt, dxt, partial, S,
                                               Lx, Ld);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rmsnorm_bwd_dw<T><<<(S.d + BLOCK - 1) / BLOCK, BLOCK, 0, s>>>(
      partial, grid, S.d, static_cast<T*>(dw));
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_occupancy(int kind, int vec, int maxv, int tpr, int d,
                  int* blocks_per_sm) {
  if (kind == 1)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, (const void*)rmsnorm_bwd_loop<T>, BLOCK, 0);
  RowsKernel<T> k = bwd_select<T>(vec, maxv);
  if (k == nullptr || tpr <= 0 || tpr > BLOCK)
    return (int)cudaErrorInvalidValue;
  const int groups = BLOCK / tpr;
  const size_t smem = groups > 1 ? (size_t)groups * d * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, (const void*)k, BLOCK, smem);
}

}  // namespace

// Launches both kernels on `stream` and returns cudaGetLastError(); never
// synchronises and allocates nothing.  dtype 0 is float32, 1 bfloat16 (x,
// w, dy, dx and dw all of it).  x's rows are laid out by (xn1, xn2, xs0,
// xs1, xs2) and dy's by (dn1, dn2, ds0, ds1, ds2), as the header says; w and
// dw are (d,) and dx (n_rows, d), contiguous; `partial` is float32 scratch
// of grid x d.  kind 0 is the register kernel (`vec` elements a load, `maxv`
// loads a thread, `tpr` threads a row), 1 the loop kernel; `grid` blocks.
extern "C" int rmsnorm_bwd_launch(
    const void* x, const void* w, const void* dy, void* dx, void* dw,
    void* partial, long long n_rows, int d, long long xn1, long long xn2,
    long long xs0, long long xs1, long long xs2, long long dn1, long long dn2,
    long long ds0, long long ds1, long long ds2, float eps, int dtype,
    int kind, int vec, int maxv, int tpr, int grid, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const Shape S{n_rows, d, eps};
  const Rows Lx{xn1, xn2, xs0, xs1, xs2};
  const Rows Ld{dn1, dn2, ds0, ds1, ds2};
  float* p = static_cast<float*>(partial);
  if (dtype == 0)
    return bwd_launch<float>(x, w, dy, dx, dw, p, S, Lx, Ld, kind, vec, maxv,
                         tpr, grid, stream);
  if (dtype == 1)
    return bwd_launch<__nv_bfloat16>(x, w, dy, dx, dw, p, S, Lx, Ld, kind, vec,
                                 maxv, tpr, grid, stream);
  return (int)cudaErrorInvalidValue;
}

// The blocks of the planned first kernel one SM holds at once, for the
// wrapper's grid.
extern "C" int rmsnorm_bwd_blocks_per_sm(int dtype, int kind, int vec,
                                         int maxv, int tpr, int d,
                                         int* blocks_per_sm) {
  if (dtype == 0)
    return bwd_occupancy<float>(kind, vec, maxv, tpr, d, blocks_per_sm);
  if (dtype == 1)
    return bwd_occupancy<__nv_bfloat16>(kind, vec, maxv, tpr, d, blocks_per_sm);
  return (int)cudaErrorInvalidValue;
}
