// Building blocks of the SIMT flash-attention kernels, the forward
// (csrc/flash_attention.cu) and the backward (csrc/flash_attention_bwd.cu):
// float32 FMAs outside the tensor cores, for float32 at head dims 16, 32,
// 64, 112 and 128 and for bfloat16 at 16 and 32.
//
// Tiles live in shared memory as float32 in one of three layouts, each
// chosen so that the reads of the products that walk it are free of bank
// conflicts and take a register plus an immediate as their address:
//   - unit-major [D/4][rows][4]: a row's 16-byte units strided by the tile's
//     rows, for tiles read as "one unit of many rows" (neighbouring lanes on
//     neighbouring rows);
//   - padded rows [rows][D + 4]: for tiles read both that way and as "many
//     units of one row" (the 16 extra bytes put row r's unit u in bank
//     group (r (D/4 + 1) + u) mod 8, distinct for eight neighbouring rows at
//     every D the route takes);
//   - swizzled rows [rows][D]: the same, with a row's units XOR-swizzled by
//     its low three bits instead of padded, where D/4 is a power of two;
//   - plain rows [rows][D]: for tiles read only a row at a time.
// float32 tiles arrive by cp.async, 16 bytes a thread, straight into their
// layout, rows past the sequence zero-filled; bfloat16 ones arrive by
// cp.async as they are in memory ([rows][D] bfloat16) and are widened once,
// by one pass of the block, into their float32 layout.  Tiles read once per
// block (the resident operands) go through registers instead, widened and
// scaled on the way.
//
// Every file that includes this one is rebuilt when it changes:
// cuda_build.CudaLibrary hashes the headers of csrc/ with each source.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace simt {

constexpr float MASKED = -1e30f;            // a masked logit, as in JAX
// shared memory an SM gives its resident blocks, and the 1 KB the system
// keeps beside each block (H100)
constexpr int SM_SMEM = 233472;
constexpr int BLOCK_RESERVED = 1024;
// slots of each kernel's cp.async ring (two operands alternate in them)
constexpr int STAGES = 2;

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

template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

template <int LANES>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 1; o < LANES; o <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int LANES>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 1; o < LANES; o <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !live (then src is
// not read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(live ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// this thread's copies have landed (a __syncthreads makes everyone's
// visible)
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// float offsets of unit u (4 floats) of row r in each layout
template <int D, int ROWS>
struct UnitMajor {
  static constexpr int FLOATS = ROWS * D;
  __device__ __forceinline__ static int at(int r, int u) {
    return (u * ROWS + r) * 4;
  }
};
template <int D, int ROWS>
struct PaddedRows {
  static constexpr int FLOATS = ROWS * (D + 4);
  __device__ __forceinline__ static int at(int r, int u) {
    return r * (D + 4) + u * 4;
  }
};
// rows whose 16-byte units are XOR-swizzled by the row's low three bits
// where a row holds a power of two of at least 8 units, else padded rows:
// either way free of conflicts read by row or by unit
template <int D, int ROWS>
struct SwizzledRows {
  static constexpr bool XOR = (D / 4) >= 8 && ((D / 4) & (D / 4 - 1)) == 0;
  static constexpr int PITCH = XOR ? D : D + 4;
  static constexpr int FLOATS = ROWS * PITCH;
  __device__ __forceinline__ static int at(int r, int u) {
    return r * PITCH + (XOR ? (u ^ (r & 7)) : u) * 4;
  }
};
template <int D, int ROWS>
struct PlainRows {
  static constexpr int FLOATS = ROWS * D;
  __device__ __forceinline__ static int at(int r, int u) {
    return r * D + u * 4;
  }
};

// rows [r0, r0 + ROWS) of a (n, D) operand at row stride rs into `dst` by
// cp.async: float32 straight into layout L, bfloat16 as it is ([ROWS][D]);
// rows at or past n are zeros.  The caller commits.
template <typename T, int D, int ROWS, int NT, typename L>
__device__ __forceinline__ void issue_rows(void* dst, const T* src,
                                           long long rs, int r0, int n) {
  constexpr int VEC = 16 / sizeof(T), CH = D / VEC;
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const bool live = r0 + r < n;
    const T* s = live ? src + (long long)(r0 + r) * rs + c * VEC : src;
    if constexpr (sizeof(T) == 4)
      cp16(static_cast<float*>(dst) + L::at(r, c), s, live);
    else
      cp16(static_cast<T*>(dst) + r * D + c * VEC, s, live);
  }
}

// a bfloat16 tile that landed as it is ([ROWS][D]) widened into layout L
template <int D, int ROWS, int NT, typename L>
__device__ __forceinline__ void widen_rows(float* dst,
                                           const __nv_bfloat16* raw) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const Pack<__nv_bfloat16, 8> pk =
        *reinterpret_cast<const Pack<__nv_bfloat16, 8>*>(raw + r * D + c * 8);
    *reinterpret_cast<float4*>(dst + L::at(r, 2 * c)) =
        make_float4(to_f(pk.v[0]), to_f(pk.v[1]), to_f(pk.v[2]),
                    to_f(pk.v[3]));
    *reinterpret_cast<float4*>(dst + L::at(r, 2 * c + 1)) =
        make_float4(to_f(pk.v[4]), to_f(pk.v[5]), to_f(pk.v[6]),
                    to_f(pk.v[7]));
  }
}

// rows [r0, r0 + ROWS) of a (n, D) operand, times `mul`, into layout L
// through registers (widened there); rows at or past n are zeros
template <typename T, int D, int ROWS, int NT, typename L>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long rs, int r0, int n,
                                          float mul) {
  constexpr int VEC = 16 / sizeof(T), CH = D / VEC;
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    float f[VEC];
    if (r0 + r < n) {
      const Pack<T, VEC> pk = *reinterpret_cast<const Pack<T, VEC>*>(
          src + (long long)(r0 + r) * rs + c * VEC);
#pragma unroll
      for (int j = 0; j < VEC; ++j) f[j] = to_f(pk.v[j]) * mul;
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) f[j] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < VEC; j += 4)
      *reinterpret_cast<float4*>(dst + L::at(r, c * (VEC / 4) + j / 4)) =
          make_float4(f[j], f[j + 1], f[j + 2], f[j + 3]);
  }
}

// VW consecutive floats (1, 2 or 4) at p
template <int VW>
__device__ __forceinline__ void read_vec(const float* p, float* out) {
  if constexpr (VW == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x;
    out[1] = x.y;
    out[2] = x.z;
    out[3] = x.w;
  } else if constexpr (VW == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x;
    out[1] = x.y;
  } else {
    out[0] = *p;
  }
}

// VW values to global memory as T
template <typename T, int VW>
__device__ __forceinline__ void write_vec(T* p, const float* v) {
  Pack<T, VW> pk;
#pragma unroll
  for (int w = 0; w < VW; ++w) pk.v[w] = from_f<T>(v[w]);
  *reinterpret_cast<Pack<T, VW>*>(p) = pk;
}

// blocks of `kernel` resident on one SM at `smem` dynamic bytes
template <typename K>
int blocks_per_sm(K kernel, int threads, int smem, int* out) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel,
                                                            threads, smem);
}

}  // namespace simt
