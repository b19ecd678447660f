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
// float operations per element: bound by device memory.  At qwen3-14b's
// training rows (4096 x 5120, and the q and k heads views of 128 bf16) that
// is 0.0376, 0.0376 and 0.0075 ms on an H100 at 3.35 TB/s.  Reaching it
// takes bytes in flight on every SM while rows reduce and store (by
// Little's law 3.35 TB/s x ~1 us / 132 SMs, about 25 KB an SM), and dw,
// a sum over every row, reduced across blocks without float atomics.
//
// Design (`rmsnorm_bwd_ring`): one cooperative launch of a persistent grid,
// as many blocks as the SMs hold (the occupancy API; two an SM at the
// training shapes, at most 384 threads and 80 registers a thread), each
// walking tiles of rows in a fixed order.
//   - The ring.  Warp 0 is the producer: it keeps `stages` shared-memory
//     stages full, each holding a tile's rows of x and of dy, paced by a
//     full and an empty mbarrier a stage.  Rows of up to 256 elements (the
//     heads views) come as one TMA box per tensor, `rows` positions of one
//     (batch, head), through a plain 4-d tensor map over x's or dy's own
//     strides (hopper::make_rows_map, no swizzle), so a strided view is
//     read in place; wider rows (d_model) come as one bulk copy per row
//     and tensor.  The launch plan (kernels/rmsnorm/kernel.py::bwd_plan)
//     sizes a stage near 32 KB and the ring near 96 KB a block, so an SM
//     has up to 192 KB of x and dy in flight.
//   - Consumers.  The other warps work the stage from shared memory: a
//     group of `tpr` threads owns a row (a power of two up to 32 for
//     narrow rows, 8 threads of two 16-byte vectors for rows of 128 bf16,
//     shuffles inside the group; every consumer thread for wide rows, one
//     named barrier over double-buffered warp sums a step), two rows at
//     once where a thread holds up to two vectors a row.  They read x and
//     dy once for both row sums and again for dx, holding nothing of a row
//     in registers across the reduction, and store dx with 16-byte stores
//     at dx's own strides.  This is what bounds the consumers: measured
//     on an H100, holding the rows in registers, or one row at a time,
//     made them slower than the memory (PERF.md).  x and dy leave device
//     memory once.
//   - dw.  Each thread keeps its columns' share of sum(dy x / r) in float32
//     registers over the block's rows, in row order; the block's groups
//     add theirs in group order into one partial row (grid x d, float32,
//     column by column when d is small).  After one grid sync every block
//     sums its share of columns over the partial rows, in block order:
//     the same order every run, so dw is bit-equal run to run, in the same
//     launch.
//   - dx's layout.  The wrapper hands dx with x's strides where x is
//     non-overlapping and dense (the heads view of a projection's output),
//     so autograd's view backward needs no copy; else contiguous.  Rows of
//     x, dy and dx each sit at their own strides over three nested row
//     dimensions common to the three (`Rows`).
// Unaligned rows, and rows too wide for two stages, take `rmsnorm_bwd_loop`
// in the same cooperative form: one row a block at a time, read twice, each
// column of the block's partial row owned by one thread.
//
// Numerics.  The backward's inverse root is rsqrtf (the forward's is
// correctly rounded); the result is held to 2^-7 (bfloat16) and 1e-4
// (float32) of the plain backward's largest value, not bit for bit.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"     // mbarriers, TMA loads and tensor maps

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

// Name of an error code (CUDA's, or a tensor map's), for the wrapper's
// exception text.
extern "C" const char* rmsnorm_error_string(int code) {
  return hopper::error_string(code);
}

// ---------------------------------------------------------------- backward

namespace {

namespace cg = cooperative_groups;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_addr;

constexpr int MAX_STAGES = 8;         // ring stages of a block
// consumer warps of a ring block: with the producer at most 384 threads,
// so two blocks fit an SM at up to 80 registers a thread
constexpr int MAX_WARPS = 11;
constexpr int LOOP_BLOCK = 256;       // threads of a loop-kernel block
constexpr int ALIGN = 128;            // stage regions start on 128 bytes

// The rows of x, dy and dx: row r = (i0 * n1 + i1) * n2 + i2 of tensor k
// (0 x, 1 dy, 2 dx) starts at i0 * s[k][0] + i1 * s[k][1] + i2 * s[k][2]
// elements.  Rows walk in runs of n2 (the positions of one (batch, head)
// of a heads view; all rows of a contiguous tensor), so a tile's rows sit
// at one stride from its first row's offset, and the index split is
// made once a tile, in 32 bits (the wrapper keeps row and tile counts
// under 2^31).
struct Rows {
  int n_rows, n1, n2;
  long long s[3][3];
  int d;
  float eps;
};

// The ring's shape: `rows` rows of x and of dy a stage (positions of one
// run), `stages` stages, each tensor's rows of a stage in `region` bytes;
// `tpr` threads a row.
struct Ring {
  int rows, stages, region, tpr;
  int tiles_per_run, n_tiles;
  int fault;
};

// tile t: its first row's offset in each tensor, its rows' stride in each,
// its first position in the run (the tensor map's coordinates) and the
// rows it holds
struct Tile {
  long long off[3], step[3];
  int p, i1, i0, valid;

  __device__ __forceinline__ Tile(const Rows& L, const Ring& R, int t) {
    const int run = t / R.tiles_per_run;
    p = (t - run * R.tiles_per_run) * R.rows;
    i1 = run % L.n1;
    i0 = run / L.n1;
    valid = min(R.rows, L.n2 - p);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      off[k] = i0 * L.s[k][0] + i1 * L.s[k][1] + (long long)p * L.s[k][2];
      step[k] = L.s[k][2];
    }
  }
};

// The blocks' partial dw rows (grid x d, float32) are summed after one
// grid sync, in the same order on every run, so dw is bit-equal run to run;
// each lane keeps LOADS partial values in flight.  With few columns (d x
// grid up to SMALL_DW) the partials are stored column by column and a warp
// sums a column, its lanes every 32nd block's value each (contiguous), and
// adds the lanes' sums by a fixed shuffle tree; else they are stored row by
// row and a block sums a group of 32 columns (a lane a column, coalesced),
// its warps every nw-th partial row each, and warp 0 adds the warps' sums
// in warp order.  Fault 1 leaves out the last block's partial row.
constexpr int LOADS = 16;
constexpr long long SMALL_DW = 1 << 16;

// where block b's partial of column col is kept
__device__ __forceinline__ long long dw_slot(int d, int b, int col) {
  return (long long)d * gridDim.x <= SMALL_DW
      ? (long long)col * gridDim.x + b : (long long)b * d + col;
}

template <typename T>
__device__ __forceinline__ void finish_dw(const float* partial, T* dw, int d,
                                         int fault) {
  __shared__ float fin[32][33];
  __threadfence();
  cg::this_grid().sync();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nw = blockDim.x / 32;
  const int nb = gridDim.x - (fault == 1 ? 1 : 0);
  // sum of p[b * step] over b = b0, b0 + stride, ... < nb, LOADS at once
  auto column = [&](const float* p, long long step, int b0, int stride) {
    float s = 0.0f;
    for (; b0 < nb; b0 += stride * LOADS) {
      float v[LOADS];
#pragma unroll
      for (int j = 0; j < LOADS; ++j) {
        const int b = b0 + j * stride;
        v[j] = b < nb ? __ldcg(p + b * step) : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < LOADS; ++j) s += v[j];
    }
    return s;
  };
  if ((long long)d * gridDim.x <= SMALL_DW) {
    for (int col = blockIdx.x * nw + warp; col < d; col += gridDim.x * nw) {
      float s = column(partial + (long long)col * gridDim.x, 1, lane, 32);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) dw[col] = from_f<T>(s);
    }
    return;
  }
  for (int g = blockIdx.x; g * 32 < d; g += gridDim.x) {
    const int col = g * 32 + lane;
    fin[warp][lane] = col < d ? column(partial + col, d, warp, nw) : 0.0f;
    __syncthreads();
    if (warp == 0 && col < d) {
      float t = 0.0f;
      for (int j = 0; j < nw; ++j) t += fin[j][lane];
      dw[col] = from_f<T>(t);
    }
    __syncthreads();
  }
}

// barrier 1 over the `nct` consumer threads (the producer warp not among
// them); each warp converges first, as bar.sync wants
__device__ __forceinline__ void consumer_sync(int nct) {
  __syncwarp();
  asm volatile("bar.sync 1, %0;\n" ::"r"(nct) : "memory");
}

// The ring kernel.  Warp 0 is the producer: lane 0 waits for a stage to be
// empty and arms its full barrier with the stage's bytes; then (MAP) lane
// 0 loads the tile of x and of dy as one box each through the tensor maps,
// or (bulk) the warp's lanes load the tile's rows with one bulk copy per
// row and tensor.  The other warps consume: a group of `tpr` threads owns
// a row of the stage (every consumer thread when tpr > 32), each thread
// its MAXV vectors of VEC elements, read from the stage for both row sums
// and again for dx, which it stores at dx's offset; it keeps its columns'
// share of dw in float32 registers over every row the block visits.
template <typename T, int VEC, int MAXV, bool MAP>
__global__ void __launch_bounds__(32 * (MAX_WARPS + 1), 2) rmsnorm_bwd_ring(
    const __grid_constant__ CUtensorMap tm_x,
    const __grid_constant__ CUtensorMap tm_dy, const T* __restrict__ x,
    const T* __restrict__ w, const T* __restrict__ dy, T* __restrict__ dx,
    T* __restrict__ dw, float* __restrict__ partial, Rows L, Ring R) {
  using P = Pack<T, VEC>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[2 * MAX_STAGES];
  __shared__ float red[2][4][32];   // wide rows: per parity, sum, warp
  uint8_t* ring =
      smem_raw + ((ALIGN - (smem_addr(smem_raw) & (ALIGN - 1))) & (ALIGN - 1));
  const int nct = blockDim.x - 32;  // consumer threads
  const int nv = L.d / VEC;
  const int row_bytes = L.d * (int)sizeof(T);
  const uint32_t full0 = smem_addr(bars), empty0 = full0 + 8 * R.stages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < R.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, nct / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {
    // ---- producer
    int i = 0;
    for (int t = blockIdx.x; t < R.n_tiles; t += gridDim.x, ++i) {
      const int s = i % R.stages;
      const uint32_t full = full0 + 8 * s;
      const uint32_t xs = smem_addr(ring) + 2 * s * R.region;
      const uint32_t ds = xs + R.region;
      const Tile tl(L, R, t);
      if (lane == 0) {
        mbar_wait(empty0 + 8 * s, ((i / R.stages) & 1) ^ 1);
        // a box always moves whole, rows past the run read as zeros
        mbar_expect_tx(full, 2 * (MAP ? R.rows : tl.valid) * row_bytes);
        if (MAP) {
          hopper::tma_load(xs, &tm_x, full, 0, tl.p, tl.i1, tl.i0);
          hopper::tma_load(ds, &tm_dy, full, 0, tl.p, tl.i1, tl.i0);
        }
      }
      if (!MAP) {
        __syncwarp();
        for (int k = lane; k < tl.valid; k += 32) {
          hopper::bulk_load(xs + k * row_bytes, x + tl.off[0] + k * tl.step[0],
                            row_bytes, full);
          hopper::bulk_load(ds + k * row_bytes,
                            dy + tl.off[1] + k * tl.step[1], row_bytes, full);
        }
      }
    }
  } else {
    // ---- consumers: U rows of the stage at once per group, so the loads,
    // shuffles and the inverse root of one row hide the other's latency
    constexpr int U = MAXV <= 2 ? 2 : 1;
    const int c = threadIdx.x - 32;
    const int tpr = R.tpr, groups = nct / tpr;
    const int g = c / tpr, lane_g = c % tpr;
    const float rd = 1.0f / (float)L.d;
    P wv[MAXV];
    float acc[MAXV][VEC];
#pragma unroll
    for (int k = 0; k < MAXV; ++k) {
      const int v = lane_g + k * tpr;
      wv[k] = v < nv ? reinterpret_cast<const P*>(w)[v] : zero_pack<T, VEC>();
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[k][j] = 0.0f;
    }
    int parity = 0;
    int i = 0;
    for (int t = blockIdx.x; t < R.n_tiles; t += gridDim.x, ++i) {
      const int s = i % R.stages;
      mbar_wait(full0 + 8 * s, (i / R.stages) & 1);
      // fault 2 reads dx's operands from the previous stage
      const int sx = R.fault == 2 ? (s + R.stages - 1) % R.stages : s;
      const uint8_t* xs = ring + 2 * s * R.region;
      const uint8_t* xs_dx = ring + 2 * sx * R.region;
      const Tile tl(L, R, t);
      const int valid = tl.valid;
      // with a map every group walks the same count of rows (a whole box),
      // so its shuffles see whole warps; wide rows use every consumer
      // thread, and the stage's rows in steps of U
      const int n = MAP ? R.rows : valid;
      for (int k0 = 0; k0 < n; k0 += groups * U) {
        int k[U];
        bool live[U];
        float ss[U], sgx[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          k[u] = k0 + u * groups + g;
          live[u] = k[u] < valid;
          ss[u] = sgx[u] = 0.0f;
        }
        // both row sums from the stage; x and dy are read from shared
        // memory again for dx, so nothing of the row waits in registers
        // across the reduction
#pragma unroll
        for (int m = 0; m < MAXV; ++m) {
          const int v = lane_g + m * tpr;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (!live[u] || v >= nv) continue;
            const P xp = reinterpret_cast<const P*>(xs + k[u] * row_bytes)[v];
            const P dp = reinterpret_cast<const P*>(xs + R.region +
                                                    k[u] * row_bytes)[v];
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              const float xv = to_f(xp.v[j]);
              ss[u] = fmaf(xv, xv, ss[u]);
              sgx[u] = fmaf(to_f(wv[m].v[j]) * to_f(dp.v[j]), xv, sgx[u]);
            }
          }
        }
        const int width = tpr < 32 ? tpr : 32;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          if (o < width)
#pragma unroll
            for (int u = 0; u < U; ++u) {
              ss[u] += __shfl_xor_sync(0xffffffffu, ss[u], o);
              sgx[u] += __shfl_xor_sync(0xffffffffu, sgx[u], o);
            }
        if (tpr > 32) {
          // the stage's rows across every consumer warp: the warps' sums
          // meet in shared memory (double-buffered, so one barrier a step
          // suffices) and each warp adds them by the same shuffle tree
          if (lane == 0)
#pragma unroll
            for (int u = 0; u < U; ++u) {
              red[parity][2 * u][c / 32] = ss[u];
              red[parity][2 * u + 1][c / 32] = sgx[u];
            }
          consumer_sync(nct);
#pragma unroll
          for (int u = 0; u < U; ++u) {
            ss[u] = lane < nct / 32 ? red[parity][2 * u][lane] : 0.0f;
            sgx[u] = lane < nct / 32 ? red[parity][2 * u + 1][lane] : 0.0f;
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
#pragma unroll
            for (int u = 0; u < U; ++u) {
              ss[u] += __shfl_xor_sync(0xffffffffu, ss[u], o);
              sgx[u] += __shfl_xor_sync(0xffffffffu, sgx[u], o);
            }
          parity ^= 1;
        }
        // dx from the same stage (fault 2: from the previous one)
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (!live[u]) continue;
          const float inv = rsqrtf(ss[u] * rd + L.eps);
          const float cc = sgx[u] * inv * inv * inv * rd;
          const P* xr = reinterpret_cast<const P*>(xs_dx + k[u] * row_bytes);
          const P* dr = reinterpret_cast<const P*>(xs_dx + R.region +
                                                   k[u] * row_bytes);
          P* orow = reinterpret_cast<P*>(dx + tl.off[2] + k[u] * tl.step[2]);
#pragma unroll
          for (int m = 0; m < MAXV; ++m) {
            const int v = lane_g + m * tpr;
            if (v >= nv) continue;
            const P xp = xr[v], dp = dr[v];
            P o;
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              const float xv = to_f(xp.v[j]), dv = to_f(dp.v[j]);
              o.v[j] = from_f<T>(fmaf(to_f(wv[m].v[j]) * dv, inv, -xv * cc));
              acc[m][j] = fmaf(dv * xv, inv, acc[m][j]);
            }
            orow[v] = o;
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }

    // the block's partial row of dw
    if (groups == 1) {                    // each column has one thread
#pragma unroll
      for (int m = 0; m < MAXV; ++m) {
        const int v = lane_g + m * tpr;
        if (v < nv)
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            partial[dw_slot(L.d, blockIdx.x, v * VEC + j)] = acc[m][j];
      }
    } else {
      // the groups' shares added in group order, through the drained ring
      float* sw = reinterpret_cast<float*>(ring);
      consumer_sync(nct);
#pragma unroll
      for (int m = 0; m < MAXV; ++m) {
        const int v = lane_g + m * tpr;
        if (v < nv)
#pragma unroll
          for (int j = 0; j < VEC; ++j) sw[g * L.d + v * VEC + j] = acc[m][j];
      }
      consumer_sync(nct);
      for (int col = c; col < L.d; col += nct) {
        float sum = 0.0f;
        for (int j = 0; j < groups; ++j) sum += sw[j * L.d + col];
        partial[dw_slot(L.d, blockIdx.x, col)] = sum;
      }
    }
  }
  __syncwarp();               // the producer's idle lanes wait for lane 0
  finish_dw<T>(partial, dw, L.d, R.fault);
}

// The two row sums over the whole block.  Every thread calls it the same
// number of times.
__device__ __forceinline__ void block_sum2(float& a, float& b,
                                           float (*red)[LOOP_BLOCK / 32]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  __syncthreads();                         // the last row's reads are done
  if ((threadIdx.x & 31) == 0) {
    red[0][threadIdx.x / 32] = a;
    red[1][threadIdx.x / 32] = b;
  }
  __syncthreads();
  a = b = 0.0f;
  for (int i = 0; i < LOOP_BLOCK / 32; ++i) {
    a += red[0][i];
    b += red[1][i];
  }
}

// Unaligned rows and rows too wide for a stage: one row a block at a time,
// read twice from device memory (the second time from L1/L2), one element
// per load; column c of the block's partial row belongs to thread
// c % LOOP_BLOCK, which adds each row's term in row order.
template <typename T>
__global__ void __launch_bounds__(LOOP_BLOCK) rmsnorm_bwd_loop(
    const T* __restrict__ x, const T* __restrict__ w,
    const T* __restrict__ dy, T* __restrict__ dx, T* __restrict__ dw,
    float* __restrict__ partial, Rows L, int fault) {
  __shared__ float red[2][LOOP_BLOCK / 32];
  for (int c = threadIdx.x; c < L.d; c += LOOP_BLOCK)
    partial[dw_slot(L.d, blockIdx.x, c)] = 0.0f;
  const Ring one{1, 0, 0, 0, L.n2, L.n_rows, 0};    // a tile a row
  for (int row = blockIdx.x; row < L.n_rows; row += gridDim.x) {
    const Tile tl(L, one, row);
    const T* xr = x + tl.off[0];
    const T* dr = dy + tl.off[1];
    float ss = 0.0f, sgx = 0.0f;
    for (int c = threadIdx.x; c < L.d; c += LOOP_BLOCK) {
      const float xv = to_f(xr[c]);
      ss = fmaf(xv, xv, ss);
      sgx = fmaf(to_f(w[c]) * to_f(dr[c]), xv, sgx);
    }
    block_sum2(ss, sgx, red);
    const float inv = 1.0f / sqrtf(ss / (float)L.d + L.eps);
    const float k = sgx * inv * inv * inv / (float)L.d;
    T* orow = dx + tl.off[2];
    for (int c = threadIdx.x; c < L.d; c += LOOP_BLOCK) {
      const float xv = to_f(xr[c]), dv = to_f(dr[c]);
      orow[c] = from_f<T>(to_f(w[c]) * dv * inv - xv * k);
      float& p = partial[dw_slot(L.d, blockIdx.x, c)];
      p = fmaf(dv * xv, inv, p);
    }
  }
  finish_dw<T>(partial, dw, L.d, fault);
}

template <typename T>
using RingKernel = void (*)(const CUtensorMap, const CUtensorMap, const T*,
                            const T*, const T*, T*, T*, float*, Rows, Ring);

// The ring kernel for (vec, maxv, map), or nullptr.
template <typename T>
RingKernel<T> ring_select(int vec, int maxv, int map) {
  constexpr int V = 16 / sizeof(T);
  if (vec != V) return nullptr;
  if (map) {
    switch (maxv) {
      case 1: return rmsnorm_bwd_ring<T, V, 1, true>;
      case 2: return rmsnorm_bwd_ring<T, V, 2, true>;
      default: return nullptr;
    }
  }
  switch (maxv) {
    case 1: return rmsnorm_bwd_ring<T, V, 1, false>;
    case 2: return rmsnorm_bwd_ring<T, V, 2, false>;
    case 4: return rmsnorm_bwd_ring<T, V, 4, false>;
    case 8: return rmsnorm_bwd_ring<T, V, 8, false>;
    default: return nullptr;
  }
}

// The kernel a plan names, with its dynamic shared memory allowed
template <typename T>
int bwd_kernel(int kind, int vec, int maxv, int map, size_t smem,
               const void** k) {
  if (kind == 1) {
    *k = (const void*)rmsnorm_bwd_loop<T>;
    return 0;
  }
  RingKernel<T> r = kind == 0 ? ring_select<T>(vec, maxv, map) : nullptr;
  if (r == nullptr) return (int)cudaErrorInvalidValue;
  *k = (const void*)r;
  // per device and cheap, so set on every call
  return (int)cudaFuncSetAttribute(
      *k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// bytes of one tensor's rows in a stage, and of the whole ring (+ room to
// align it)
int region_bytes(int rows, int d, int size) {
  return (rows * d * size + ALIGN - 1) / ALIGN * ALIGN;
}
size_t ring_smem(int rows, int stages, int d,
                                          int size) {
  return (size_t)2 * stages * region_bytes(rows, d, size) + ALIGN;
}

cudaError_t cooperative(const void* k, int grid, int block, size_t smem,
                        cudaStream_t s, void** args) {
  return cudaLaunchCooperativeKernel(k, dim3(grid), dim3(block), args, smem,
                                     s);
}

template <typename T>
int bwd_launch(const void* x, const void* w, const void* dy, void* dx,
               void* dw, float* partial, const Rows& L, int kind, int map,
               int vec, int maxv, int tpr, int warps, int rows, int stages,
               int grid, int fault, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  T* dwt = static_cast<T*>(dw);
  if (grid <= 0 || fault < 0 || fault > 2) return (int)cudaErrorInvalidValue;
  const void* k = nullptr;
  if (kind == 1) {
    int err = bwd_kernel<T>(1, 1, 1, 0, 0, &k);
    if (err) return err;
    Rows Lc = L;
    void* args[] = {&xt, &wt, &dyt, &dxt, &dwt, &partial, &Lc, &fault};
    return (int)cooperative(k, grid, LOOP_BLOCK, 0, s, args);
  }
  // the ring kernel: validate the plan against the kernel's assumptions
  const int nct = 32 * warps, nv = L.d / (vec > 0 ? vec : 1);
  const bool ok =
      kind == 0 && warps >= 1 && warps <= MAX_WARPS && rows >= 1 &&
      stages >= 2 && stages <= MAX_STAGES && (long long)tpr * maxv >= nv &&
      rows % ((map ? nct / tpr : 1) * (maxv <= 2 ? 2 : 1)) == 0 &&
      (map ? (tpr >= 1 && tpr <= 32 && (tpr & (tpr - 1)) == 0 &&
              rows <= 256 && L.d <= 256)
           : tpr == nct);
  if (!ok) return (int)cudaErrorInvalidValue;
  const size_t smem = ring_smem(rows, stages, L.d, sizeof(T));
  int err = bwd_kernel<T>(0, vec, maxv, map, smem, &k);
  if (err) return err;
  Ring R{rows, stages, region_bytes(rows, L.d, sizeof(T)), tpr, 0, 0,
         fault};
  CUtensorMap mx, md;
  memset(&mx, 0, sizeof(mx));
  memset(&md, 0, sizeof(md));
  R.tiles_per_run = (L.n2 + rows - 1) / rows;
  const long long n_tiles = (long long)(L.n_rows / L.n2) * R.tiles_per_run;
  if (n_tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
  R.n_tiles = (int)n_tiles;
  if (map) {
    hopper::EncodeTiled encode;
    if ((err = hopper::encoder(&encode))) return err;
    const CUtensorMapDataType dt = sizeof(T) == 4
        ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const long long n0 = L.n_rows / ((long long)L.n1 * L.n2);
    if ((err = hopper::make_rows_map(encode, &mx, x, dt, sizeof(T), L.d, L.n2,
                                     L.n1, n0, L.s[0], rows)) ||
        (err = hopper::make_rows_map(encode, &md, dy, dt, sizeof(T), L.d,
                                     L.n2, L.n1, n0, L.s[1], rows)))
      return err;
  }
  Rows Lc = L;
  void* args[] = {&mx, &md, &xt, &wt, &dyt, &dxt, &dwt, &partial, &Lc, &R};
  return (int)cooperative(k, grid, nct + 32, smem, s, args);
}

template <typename T>
int bwd_occupancy(int kind, int map, int vec, int maxv, int block, int rows,
                  int stages, int d, int* blocks_per_sm) {
  const size_t smem = kind == 1 ? 0 : ring_smem(rows, stages, d, sizeof(T));
  const void* k = nullptr;
  const int err = bwd_kernel<T>(kind, vec, maxv, map, smem, &k);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, k,
                                                            block, smem);
}

}  // namespace

// Launches the backward on `stream` as one cooperative launch and returns
// 0 or an error code; never synchronises and allocates nothing.  dtype 0 is
// float32, 1 bfloat16 (x, w, dy, dx and dw all of it).  The rows of x, dy
// and dx are laid out as `Rows` says: n_rows rows in nested dimensions
// (n_rows / (n1 n2), n1, n2), `strides` holding the element strides over
// them of x, then dy, then dx (nine in all); w and dw are (d,) contiguous;
// `partial` is float32 scratch of grid x d.  kind 0 is the ring kernel
// (`map` 1 for tensor-map tiles, 0 for bulk copies of rows; `vec` elements
// a vector, `maxv` vectors a thread, `tpr` threads a row, `warps` consumer
// warps, `rows` rows a stage, `stages` stages), 1 the loop kernel; `grid`
// blocks, all resident at once; `fault` 0, or a planted fault (1: dw
// without the last block's partial row; 2: dx from the previous stage).
extern "C" int rmsnorm_bwd_launch(
    const void* x, const void* w, const void* dy, void* dx, void* dw,
    void* partial, long long n_rows, int d, long long n1, long long n2,
    const long long* strides, float eps, int dtype, int kind, int map,
    int vec, int maxv, int tpr, int warps, int rows, int stages, int grid,
    int fault, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (n_rows <= 0 || n_rows > INT32_MAX || n1 <= 0 || n2 <= 0)
    return (int)cudaErrorInvalidValue;
  Rows L{(int)n_rows, (int)n1, (int)n2, {}, d, eps};
  for (int k = 0; k < 3; ++k)
    for (int j = 0; j < 3; ++j) L.s[k][j] = strides[3 * k + j];
  float* p = static_cast<float*>(partial);
  if (dtype == 0)
    return bwd_launch<float>(x, w, dy, dx, dw, p, L, kind, map, vec, maxv,
                             tpr, warps, rows, stages, grid, fault, stream);
  if (dtype == 1)
    return bwd_launch<__nv_bfloat16>(x, w, dy, dx, dw, p, L, kind, map, vec,
                                     maxv, tpr, warps, rows, stages, grid,
                                     fault, stream);
  return (int)cudaErrorInvalidValue;
}

// The blocks of the planned backward kernel one SM holds at once, for the
// wrapper's grid (the cooperative launch needs every block resident).
extern "C" int rmsnorm_bwd_blocks_per_sm(int dtype, int kind, int map,
                                         int vec, int maxv, int block,
                                         int rows, int stages, int d,
                                         int* blocks_per_sm) {
  if (dtype == 0)
    return bwd_occupancy<float>(kind, map, vec, maxv, block, rows, stages, d,
                                blocks_per_sm);
  if (dtype == 1)
    return bwd_occupancy<__nv_bfloat16>(kind, map, vec, maxv, block, rows,
                                        stages, d, blocks_per_sm);
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------------ split rows
//
// A row cut into column blocks, one a rank: Mamba2's gated norm runs over
// the inner width, which 'model' shards, so a rank holds d = n / tp columns
// of each row of n.  Rows are contiguous (n_rows x d).  With
// inv = 1 / sqrt(total / n + eps), n the whole row's width, in float32:
//
// The forward takes three steps, the middle one a collective the caller
// makes (an all-reduce of one float32 a row):
//   1. `rmsnorm_split_rows` writes the block's partial sum(x^2) of each row
//      (a warp a row);
//   2. the partials are summed over the ranks, the row's `total`;
//   3. `rmsnorm_split_apply` writes y = (x * inv) * w, rounded once, one
//      16-byte vector (or one element where the rows are not whole vectors)
//      a thread.
// Each reads x once and writes its output once: bound by device memory.
//
// The backward, given the forward's `total`:
//   dot = sum(w * dy * x) over the whole row      (the caller's all-reduce)
//   dx  = (w * dy) * inv - x * (inv^3 * dot / n)
//   dw  = sum over this rank's rows of dy * x * inv
// What bounds it: x and dy read and dx written once, three tensors (0.0526
// ms on an H100 at 3.35 TB/s for one rank's block of zamba2-7b's gated
// norm, 16384 x 1792 bf16).  But dx needs the row's dot summed over the
// ranks, so x and dy are read again after the all-reduce: the two passes
// move five tensors (0.0877 ms there), less what the 50 MB L2 still holds
// of the first read.  Two launches around the all-reduce, each a
// persistent grid of the same `grid` blocks (as many as the SMs hold of
// the two, the occupancy API); a group of `tpr` threads owns a row, each
// thread up to MAXV 16-byte vectors of it in registers (the wrapper aims
// for 4: 64 threads a row of 1792 bf16, 16 of 512; a thread of a wider row
// takes the vectors past MAXV one at a time), and tiles of `groups` rows are
// dealt to the blocks in turn (tile b + k * grid is block b's step k), so
// the grid sweeps the rows front to back:
//   - `rmsnorm_split_bwd_rows` (before the all-reduce) reads x and dy once
//     and writes each row's partial dot and the block's partial dw: each
//     group adds its rows' dy * x * inv, in row order, into its own float32
//     row of d in shared memory (no two threads touch a column, so no
//     atomics; held in registers they cost the SM blocks), then the block
//     adds its groups' rows in group order into one row of `partial` (grid
//     x d).  dx then needs nothing column-wise.  A row of several warps
//     keeps their sums of the dot for SPLIT_STEPS steps between syncs.
//   - `rmsnorm_split_bwd_dx` (after it) sums its share of dw's columns
//     over the partial rows in a fixed order (SPLIT_RUNS runs of
//     consecutive blocks, each in block order, then the runs in order:
//     bit-equal run to run, no float atomics), then writes dx in 16-byte
//     vectors, each thread taking its row's two coefficients once a row,
//     sweeping the rows back to front: the rows the first pass read last,
//     still in the L2, come first.
// On an H100 (PERF.md) contiguous row ranges a block, sums in registers,
// fewer threads a row, evict-first hints and 256-byte L2 fetches were
// each slower or no faster.  The weight sits in shared memory in both.
// The dw sums go to the grid's last blocks, which the dealt tiles leave a
// step lighter.  Row and element indices are 32-bit: the wrapper refuses
// 2^31 elements.  inv is computed as the forward computes it (1.0f /
// sqrtf, both correctly rounded).  Plain
// versions: ref.py's split_sumsq, rmsnorm_split, split_bwd_rows (the first
// pass: dots and each block's partial dw) and split_bwd_dx (the second:
// dx and the partials summed in order).

namespace {

constexpr int SPLIT_BLOCK = 256;
constexpr int SPLIT_WARPS = SPLIT_BLOCK / 32;
constexpr int SPLIT_STEPS = 16;   // steps between the first pass's syncs
constexpr int SPLIT_RUNS = 16;    // runs of partial rows in dw's sum

// sum(x^2), one warp a row
template <typename T, int VEC>
__global__ void __launch_bounds__(SPLIT_BLOCK) rmsnorm_split_rows(
    const T* __restrict__ x, float* __restrict__ out, long long n_rows,
    int d) {
  using P = Pack<T, VEC>;
  const int lane = threadIdx.x % 32;
  const long long row =
      (long long)blockIdx.x * (SPLIT_BLOCK / 32) + threadIdx.x / 32;
  if (row >= n_rows) return;
  const int nv = d / VEC;
  const P* xr = reinterpret_cast<const P*>(x + row * d);
  float s = 0.0f;
  for (int v = lane; v < nv; v += 32) {
    const P p = xr[v];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float f = to_f(p.v[j]);
      s = fmaf(f, f, s);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) out[row] = s;
}

// y = (x * inv) * w, a vector of VEC elements a thread, grid-stride
template <typename T, int VEC>
__global__ void __launch_bounds__(SPLIT_BLOCK) rmsnorm_split_apply(
    const T* __restrict__ x, const T* __restrict__ w,
    const float* __restrict__ total, T* __restrict__ y, long long n_rows,
    int d, int n, float eps) {
  using P = Pack<T, VEC>;
  const int nv = d / VEC;
  const long long count = n_rows * nv;
  const P* xp = reinterpret_cast<const P*>(x);
  const P* wp = reinterpret_cast<const P*>(w);
  P* yp = reinterpret_cast<P*>(y);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < count; i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / nv;
    const float inv = 1.0f / sqrtf(total[row] / (float)n + eps);
    const P p = xp[i], q = wp[i - row * nv];
    P o;
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      o.v[j] = from_f<T>((to_f(p.v[j]) * inv) * to_f(q.v[j]));
    yp[i] = o;
  }
}

// Bytes of the backward's dynamic shared memory: the weight, padded to 16
// bytes, then (the first pass) a float32 row of d a group.
__host__ __device__ inline size_t split_w_bytes(int d, size_t size) {
  return (d * size + 15) / 16 * 16;
}
inline size_t split_rows_smem(int d, size_t size, int tpr) {
  return split_w_bytes(d, size) + (size_t)(SPLIT_BLOCK / tpr) * d * 4;
}

// Block b's steps: tiles b, b + grid, ... of `groups` rows.
__device__ __forceinline__ int split_steps(int n_rows, int groups) {
  const int tiles = (n_rows + groups - 1) / groups, b = blockIdx.x;
  return tiles > b ? (tiles - 1 - b) / (int)gridDim.x + 1 : 0;
}
__device__ __forceinline__ int split_first(int step, int groups) {
  return ((int)blockIdx.x + step * (int)gridDim.x) * groups;
}

// The weight into shared memory, as vectors.
template <typename P>
__device__ __forceinline__ void split_weight(P* ws, const void* w, int nv) {
  const P* wp = static_cast<const P*>(w);
  for (int i = threadIdx.x; i < nv; i += blockDim.x) ws[i] = wp[i];
}

// One vector of the first pass: its terms of the row's dot added into
// `s`, dy * x * inv into the group's sums `m` (VEC floats).
template <typename T, int VEC>
__device__ __forceinline__ void split_rows_vec(const Pack<T, VEC> xv,
                                               const Pack<T, VEC> gv,
                                               const Pack<T, VEC> wv,
                                               float* m, float inv,
                                               float& s) {
  float a[VEC];
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(m)[q];
      a[4 * q] = f.x;
      a[4 * q + 1] = f.y;
      a[4 * q + 2] = f.z;
      a[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) a[j] = m[j];
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float xf = to_f(xv.v[j]), gf = to_f(gv.v[j]);
    s = fmaf(to_f(wv.v[j]) * gf, xf, s);
    a[j] = fmaf(gf * xf, inv, a[j]);
  }
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q)
      reinterpret_cast<float4*>(m)[q] =
          make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) m[j] = a[j];
  }
}

// One vector of dx: (w * dy) * inv - x * cf.
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> split_dx_vec(const Pack<T, VEC> xv,
                                                     const Pack<T, VEC> gv,
                                                     const Pack<T, VEC> wv,
                                                     float inv, float cf) {
  Pack<T, VEC> o;
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    o.v[j] = from_f<T>(to_f(wv.v[j]) * to_f(gv.v[j]) * inv -
                       to_f(xv.v[j]) * cf);
  return o;
}

// The first pass: row r's partial dot into dot[r], the block's partial dw
// into partial[blockIdx.x * d + c].  WIDE: a row holds more than MAXV
// vectors a thread (instances of their own, so that the loop over the rest
// costs the narrower rows nothing).
template <typename T, int VEC, int MAXV, bool WIDE>
__global__ void __launch_bounds__(SPLIT_BLOCK) rmsnorm_split_bwd_rows(
    const T* __restrict__ x, const T* __restrict__ w,
    const T* __restrict__ dy, const float* __restrict__ total,
    float* __restrict__ dot, float* __restrict__ partial, int n_rows, int d,
    int n, float eps, int tpr) {
  using P = Pack<T, VEC>;
  extern __shared__ __align__(16) unsigned char split_smem[];
  __shared__ float red[SPLIT_STEPS][SPLIT_WARPS];  // warps' dots a step
  P* ws = reinterpret_cast<P*>(split_smem);
  float* sums =
      reinterpret_cast<float*>(split_smem + split_w_bytes(d, sizeof(T)));
  const int nv = d / VEC;
  const int groups = blockDim.x / tpr;
  const int g = threadIdx.x / tpr, t = threadIdx.x % tpr;
  split_weight(ws, w, nv);
  for (int c = threadIdx.x; c < groups * d; c += blockDim.x) sums[c] = 0.0f;
  __syncthreads();
  float* mine = sums + g * d;
  const P* xp = reinterpret_cast<const P*>(x);
  const P* gp = reinterpret_cast<const P*>(dy);
  const int steps = split_steps(n_rows, groups);
  for (int step = 0; step < steps; ++step) {
    const int r = split_first(step, groups) + g;
    float s = 0.0f;
    if (r < n_rows) {
      const float inv = 1.0f / sqrtf(total[r] / (float)n + eps);
      P xv[MAXV], gv[MAXV];
#pragma unroll
      for (int v = 0; v < MAXV; ++v) {
        const int i = t + v * tpr;
        if (i < nv) {
          xv[v] = xp[r * nv + i];
          gv[v] = gp[r * nv + i];
        }
      }
#pragma unroll
      for (int v = 0; v < MAXV; ++v) {
        const int i = t + v * tpr;
        if (i < nv)
          split_rows_vec(xv[v], gv[v], ws[i], mine + i * VEC, inv, s);
      }
      // a row wider than MAXV vectors a thread: the rest one at a time
      if constexpr (WIDE) {
        for (int i = t + MAXV * tpr; i < nv; i += tpr)
          split_rows_vec(xp[r * nv + i], gp[r * nv + i], ws[i],
                         mine + i * VEC, inv, s);
      }
    }
    // the row's dot: shuffles inside the group; a row of several warps
    // keeps their sums for SPLIT_STEPS steps, then adds them in warp order
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      if (o < tpr) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (tpr <= 32) {
      if (t == 0 && r < n_rows) dot[r] = s;
    } else {
      const int slot = step % SPLIT_STEPS;
      if (threadIdx.x % 32 == 0) red[slot][threadIdx.x / 32] = s;
      if (slot == SPLIT_STEPS - 1 || step == steps - 1) {
        __syncthreads();
        const int wpr = tpr / 32;
        for (int j = 0; j <= slot && t == 0; ++j) {
          const int row = split_first(step - slot + j, groups) + g;
          if (row < n_rows) {
            float u = red[j][g * wpr];
            for (int k = 1; k < wpr; ++k) u += red[j][g * wpr + k];
            dot[row] = u;
          }
        }
        __syncthreads();
      }
    }
  }
  // the groups' rows added in group order: the block's partial row
  __syncthreads();
  float* out = partial + (long long)blockIdx.x * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float u = sums[c];
    for (int k = 1; k < groups; ++k) u += sums[k * d + c];
    out[c] = u;
  }
}

// dw[c] for this block's share of the columns: the `parts` partial rows in
// SPLIT_RUNS runs of consecutive rows, each summed in order by one thread,
// then the runs in order.  `drop_last` leaves out the last partial row (a
// planted fault).
template <typename T>
__device__ __forceinline__ void split_dw(const float* __restrict__ partial,
                                         T* __restrict__ dw, int d,
                                         int parts, bool drop_last) {
  constexpr int W = SPLIT_BLOCK / SPLIT_RUNS;     // columns a tile
  __shared__ float red[SPLIT_RUNS][W];
  const int col = threadIdx.x % W, q = threadIdx.x / W;
  const int kept = drop_last ? parts - 1 : parts;
  const int k0 = q * kept / SPLIT_RUNS, k1 = (q + 1) * kept / SPLIT_RUNS;
  for (int tile = gridDim.x - 1 - blockIdx.x; tile * W < d;
       tile += gridDim.x) {
    const int c = tile * W + col;
    float s = 0.0f;
    if (c < d) {
#pragma unroll 4
      for (int k = k0; k < k1; ++k) s += partial[(long long)k * d + c];
    }
    red[q][col] = s;
    __syncthreads();
    if (q == 0 && c < d) {
      float u = red[0][col];
      for (int k = 1; k < SPLIT_RUNS; ++k) u += red[k][col];
      dw[c] = from_f<T>(u);
    }
    __syncthreads();
  }
}

// The second pass: dw from the first pass's `gridDim.x` partial rows, then
// dx of the block's rows, its steps from the last back.  `fault` plants one
// for chip_smoke.py's check: 1 sums dw without the last block's partial
// row; 2 takes each row's coefficients from its neighbour (row r ^ 1).
template <typename T, int VEC, int MAXV, bool WIDE>
__global__ void __launch_bounds__(SPLIT_BLOCK) rmsnorm_split_bwd_dx(
    const T* __restrict__ x, const T* __restrict__ w,
    const T* __restrict__ dy, const float* __restrict__ total,
    const float* __restrict__ dot, const float* __restrict__ partial,
    T* __restrict__ dx, T* __restrict__ dw, int n_rows, int d, int n,
    float eps, int tpr, int fault) {
  using P = Pack<T, VEC>;
  extern __shared__ __align__(16) unsigned char split_smem[];
  P* ws = reinterpret_cast<P*>(split_smem);
  const int nv = d / VEC;
  split_dw(partial, dw, d, gridDim.x, fault == 1);
  split_weight(ws, w, nv);
  __syncthreads();
  const int groups = blockDim.x / tpr;
  const int g = threadIdx.x / tpr, t = threadIdx.x % tpr;
  const P* xp = reinterpret_cast<const P*>(x);
  const P* gp = reinterpret_cast<const P*>(dy);
  P* dp = reinterpret_cast<P*>(dx);
  const int steps = split_steps(n_rows, groups);
  for (int k = steps - 1; k >= 0; --k) {
    const int r = split_first(k, groups) + g;
    if (r >= n_rows) continue;
    const int rc = fault == 2 && (r ^ 1) < n_rows ? r ^ 1 : r;
    const float inv = 1.0f / sqrtf(total[rc] / (float)n + eps);
    const float cf = inv * inv * inv * dot[rc] / (float)n;
    P xv[MAXV], gv[MAXV];
#pragma unroll
    for (int v = 0; v < MAXV; ++v) {
      const int i = t + v * tpr;
      if (i < nv) {
        xv[v] = xp[r * nv + i];
        gv[v] = gp[r * nv + i];
      }
    }
#pragma unroll
    for (int v = 0; v < MAXV; ++v) {
      const int i = t + v * tpr;
      if (i < nv)
        dp[r * nv + i] = split_dx_vec(xv[v], gv[v], ws[i], inv, cf);
    }
    if constexpr (WIDE) {
      for (int i = t + MAXV * tpr; i < nv; i += tpr)
        dp[r * nv + i] =
            split_dx_vec(xp[r * nv + i], gp[r * nv + i], ws[i], inv, cf);
    }
  }
}

template <typename T>
using SplitRowsKernel = void (*)(const T*, const T*, const T*, const float*,
                                 float*, float*, int, int, int, float, int);
template <typename T>
using SplitDxKernel = void (*)(const T*, const T*, const T*, const float*,
                               const float*, const float*, T*, T*, int, int,
                               int, float, int, int);

// The two passes' instances of a vector width and MAXV: MAXV 1, 2, 4 or 8
// for 16-byte vectors, up to 16 for single elements; a row of `d` wider
// than `tpr` threads of MAXV vectors takes the WIDE instance of the
// largest MAXV.
template <typename T>
int split_bwd_kernels(int vec, int maxv, int tpr, int d,
                      SplitRowsKernel<T>* a, SplitDxKernel<T>* b) {
  constexpr int V = 16 / sizeof(T);
  const bool wide = (long long)tpr * maxv * vec < d;
#define SPLIT_BWD_CASE(VV, M, W)              \
  if (vec == VV && maxv == M && wide == W) {  \
    *a = rmsnorm_split_bwd_rows<T, VV, M, W>; \
    *b = rmsnorm_split_bwd_dx<T, VV, M, W>;   \
    return 0;                                 \
  }
  SPLIT_BWD_CASE(V, 1, false)
  SPLIT_BWD_CASE(V, 2, false)
  SPLIT_BWD_CASE(V, 4, false)
  SPLIT_BWD_CASE(V, 8, false)
  SPLIT_BWD_CASE(V, 8, true)
  SPLIT_BWD_CASE(1, 1, false)
  SPLIT_BWD_CASE(1, 2, false)
  SPLIT_BWD_CASE(1, 4, false)
  SPLIT_BWD_CASE(1, 8, false)
  SPLIT_BWD_CASE(1, 16, false)
  SPLIT_BWD_CASE(1, 16, true)
#undef SPLIT_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory past the default 48 KB is asked for per kernel.
cudaError_t split_smem_limit(const void* k, size_t smem) {
  if (smem <= (48 << 10)) return cudaSuccess;
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T>
int split_rows(const void* x, float* out, long long n_rows, int d, int vec,
               cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  const long long grid = (n_rows + SPLIT_BLOCK / 32 - 1) / (SPLIT_BLOCK / 32);
  if (grid > INT32_MAX || (vec != 1 && vec != V) || d % vec)
    return (int)cudaErrorInvalidValue;
  if (vec == V)
    rmsnorm_split_rows<T, V><<<(int)grid, SPLIT_BLOCK, 0, s>>>(xt, out,
                                                               n_rows, d);
  else
    rmsnorm_split_rows<T, 1><<<(int)grid, SPLIT_BLOCK, 0, s>>>(xt, out,
                                                               n_rows, d);
  return (int)cudaGetLastError();
}

template <typename T>
int split_apply(const void* x, const void* w, const float* total, void* y,
                long long n_rows, int d, int n, float eps, int vec, int grid,
                cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
  if (grid <= 0 || (vec != 1 && vec != V) || d % vec)
    return (int)cudaErrorInvalidValue;
  if (vec == V)
    rmsnorm_split_apply<T, V><<<grid, SPLIT_BLOCK, 0, s>>>(
        xt, wt, total, yt, n_rows, d, n, eps);
  else
    rmsnorm_split_apply<T, 1><<<grid, SPLIT_BLOCK, 0, s>>>(
        xt, wt, total, yt, n_rows, d, n, eps);
  return (int)cudaGetLastError();
}

// The backward's two instances, after checking what both passes take: a
// group of tpr threads (a power of two from 8 to 256) a row, 32-bit
// indices, at most a block a tile.
template <typename T>
int split_bwd_plan(long long n_rows, int d, int vec, int maxv, int tpr,
                   int grid, SplitRowsKernel<T>* a, SplitDxKernel<T>* b) {
  if (n_rows <= 0 || d <= 0 || d % vec || n_rows * d > INT32_MAX ||
      tpr < 8 || tpr > SPLIT_BLOCK || (tpr & (tpr - 1)) || grid <= 0 ||
      grid > (n_rows + SPLIT_BLOCK / tpr - 1) / (SPLIT_BLOCK / tpr))
    return (int)cudaErrorInvalidValue;
  return split_bwd_kernels<T>(vec, maxv, tpr, d, a, b);
}

template <typename T>
int split_bwd_rows(const void* x, const void* w, const void* dy,
                   const float* total, float* dot, float* partial,
                   long long n_rows, int d, int n, float eps, int vec,
                   int maxv, int tpr, int grid, cudaStream_t s) {
  SplitRowsKernel<T> a;
  SplitDxKernel<T> b;
  int err = split_bwd_plan<T>(n_rows, d, vec, maxv, tpr, grid, &a, &b);
  if (err) return err;
  const size_t smem = split_rows_smem(d, sizeof(T), tpr);
  err = (int)split_smem_limit((const void*)a, smem);
  if (err) return err;
  a<<<grid, SPLIT_BLOCK, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(dy), total, dot, partial, (int)n_rows, d, n, eps,
      tpr);
  return (int)cudaGetLastError();
}

template <typename T>
int split_bwd_dx(const void* x, const void* w, const void* dy,
                 const float* total, const float* dot, const float* partial,
                 void* dx, void* dw, long long n_rows, int d, int n,
                 float eps, int vec, int maxv, int tpr, int grid, int fault,
                 cudaStream_t s) {
  SplitRowsKernel<T> a;
  SplitDxKernel<T> b;
  int err = split_bwd_plan<T>(n_rows, d, vec, maxv, tpr, grid, &a, &b);
  if (err) return err;
  if (fault < 0 || fault > 2) return (int)cudaErrorInvalidValue;
  const size_t smem = split_w_bytes(d, sizeof(T));
  err = (int)split_smem_limit((const void*)b, smem);
  if (err) return err;
  b<<<grid, SPLIT_BLOCK, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(dy), total, dot, partial, static_cast<T*>(dx),
      static_cast<T*>(dw), (int)n_rows, d, n, eps, tpr, fault);
  return (int)cudaGetLastError();
}

template <typename T>
int split_bwd_occupancy(int vec, int maxv, int tpr, int d,
                        int* blocks_per_sm) {
  SplitRowsKernel<T> a;
  SplitDxKernel<T> b;
  int err = split_bwd_kernels<T>(vec, maxv, tpr, d, &a, &b);
  if (err) return err;
  const size_t sa = split_rows_smem(d, sizeof(T), tpr);
  const size_t sb = split_w_bytes(d, sizeof(T));
  int na = 0, nb = 0;
  err = (int)split_smem_limit((const void*)a, sa);
  if (!err) err = (int)split_smem_limit((const void*)b, sb);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &na, (const void*)a, SPLIT_BLOCK, sa);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &nb, (const void*)b, SPLIT_BLOCK, sb);
  *blocks_per_sm = na < nb ? na : nb;
  return err;
}

}  // namespace

// The forward's partial sums: each row's sum(x^2), float32, into `out`
// (n_rows); x is (n_rows, d) contiguous; `vec` is 16 / sizeof(dtype) where
// x starts on 16 bytes and d is whole vectors, else 1.
extern "C" int rmsnorm_split_rows_launch(const void* x, void* out,
                                         long long n_rows, int d, int dtype,
                                         int vec, void* stream_ptr) {
  cudaStream_t s = (cudaStream_t)stream_ptr;
  float* o = static_cast<float*>(out);
  if (n_rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return split_rows<float>(x, o, n_rows, d, vec, s);
  if (dtype == 1) return split_rows<__nv_bfloat16>(x, o, n_rows, d, vec, s);
  return (int)cudaErrorInvalidValue;
}

// y (n_rows, d) = x normed by each row's `total` (float32, summed over the
// whole row of `n`) times w; `grid` blocks of 256 threads walk the vectors.
extern "C" int rmsnorm_split_apply_launch(const void* x, const void* w,
                                          const void* total, void* y,
                                          long long n_rows, int d, int n,
                                          float eps, int dtype, int vec,
                                          int grid, void* stream_ptr) {
  cudaStream_t s = (cudaStream_t)stream_ptr;
  const float* t = static_cast<const float*>(total);
  if (n_rows <= 0 || d <= 0 || n < d) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return split_apply<float>(x, w, t, y, n_rows, d, n, eps, vec, grid, s);
  if (dtype == 1)
    return split_apply<__nv_bfloat16>(x, w, t, y, n_rows, d, n, eps, vec,
                                      grid, s);
  return (int)cudaErrorInvalidValue;
}

// The backward's first pass: each row's partial sum(w * dy * x) into `dot`
// (n_rows, float32) and each block's partial dw into `partial` (grid x d,
// float32), from x, w, dy ((n_rows, d) and (d,), contiguous, 16-byte
// aligned where `vec` > 1) and the rows' `total` (float32, over the whole
// row of `n`).  `tpr` threads a row, at most `maxv` vectors of `vec`
// elements a thread, `grid` blocks of 256 threads.
extern "C" int rmsnorm_split_bwd_rows_launch(
    const void* x, const void* w, const void* dy, const void* total,
    void* dot, void* partial, long long n_rows, int d, int n, float eps,
    int dtype, int vec, int maxv, int tpr, int grid, void* stream_ptr) {
  cudaStream_t s = (cudaStream_t)stream_ptr;
  const float* t = static_cast<const float*>(total);
  float* g = static_cast<float*>(dot);
  float* p = static_cast<float*>(partial);
  if (n < d) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return split_bwd_rows<float>(x, w, dy, t, g, p, n_rows, d, n, eps, vec,
                                 maxv, tpr, grid, s);
  if (dtype == 1)
    return split_bwd_rows<__nv_bfloat16>(x, w, dy, t, g, p, n_rows, d, n,
                                         eps, vec, maxv, tpr, grid, s);
  return (int)cudaErrorInvalidValue;
}

// The backward's second pass: dx (n_rows, d) and dw (d,) from the rows'
// `dot` summed over the whole row and the first pass's partial rows; the
// plan as the first pass's; `fault` 0 or a planted fault.
extern "C" int rmsnorm_split_bwd_dx_launch(
    const void* x, const void* w, const void* dy, const void* total,
    const void* dot, const void* partial, void* dx, void* dw,
    long long n_rows, int d, int n, float eps, int dtype, int vec, int maxv,
    int tpr, int grid, int fault, void* stream_ptr) {
  cudaStream_t s = (cudaStream_t)stream_ptr;
  const float* t = static_cast<const float*>(total);
  const float* g = static_cast<const float*>(dot);
  const float* p = static_cast<const float*>(partial);
  if (n < d) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return split_bwd_dx<float>(x, w, dy, t, g, p, dx, dw, n_rows, d, n, eps,
                               vec, maxv, tpr, grid, fault, s);
  if (dtype == 1)
    return split_bwd_dx<__nv_bfloat16>(x, w, dy, t, g, p, dx, dw, n_rows, d,
                                       n, eps, vec, maxv, tpr, grid, fault,
                                       s);
  return (int)cudaErrorInvalidValue;
}

// The blocks of 256 threads of both passes' instances one SM holds at once
// (the fewer of the two), for the wrapper's grid.
extern "C" int rmsnorm_split_bwd_blocks_per_sm(int dtype, int vec, int maxv,
                                               int tpr, int d,
                                               int* blocks_per_sm) {
  if (dtype == 0)
    return split_bwd_occupancy<float>(vec, maxv, tpr, d, blocks_per_sm);
  if (dtype == 1)
    return split_bwd_occupancy<__nv_bfloat16>(vec, maxv, tpr, d,
                                              blocks_per_sm);
  return (int)cudaErrorInvalidValue;
}
