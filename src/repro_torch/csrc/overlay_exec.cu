// Overlay executor for Hopper (sm_90a): runs an OverlayProgram, the
// linearised form of a placed-and-routed overlay kernel, over N work-items.
//
// Replaces the Pallas TPU kernel `_exec_kernel`, launched by
// `overlay_execute` (src/repro/kernels/overlay_exec/kernel.py).  Plain
// version: src/repro_torch/kernels/overlay_exec/ref.py::execute_image.
// Binding and launch plan: src/repro_torch/kernels/overlay_exec/kernel.py
// (ctypes).
//
// Program as data.  The instruction count, the register-file size and the
// number of inputs and outputs are runtime arguments, and the instruction
// rows (opcode, dst, a, b, c, imm_port) and immediates come from device
// buffers.  One build serves every program: swapping kernels is a write into
// those buffers, the analogue of the paper's partial reconfiguration.
// Triton does not fit: the register file is indexed by slot numbers known
// only at run time, and specialising the kernel per program would bring back
// the per-kernel compile that the overlay exists to avoid.
//
// What bounds it.  Each work-item reads n_in and writes n_out floats: at
// N = 2^24 that is 134-335 MB per launch, bound by device memory (3.35 TB/s
// on an H100 SXM).  The interpreter sits on top: a register slot indexed at
// run time cannot live in a thread's registers, so the register file lives
// in shared memory, and each instruction is decoded and dispatched at run
// time.  Measured on an H100 (PERF.md), a one-instruction program streams
// at 0.90 of a plain copy, and each further instruction costs a fixed
// decode-and-dispatch chain per warp, whatever the operands' traffic: for
// the paper's 5-14 instruction programs that chain, not the bytes, is the
// larger cost.
//
// Design.
//   - W = 8, 4, 2 or 1 work-items a thread (a template instance each,
//     chosen by the wrapper from the shared memory a block may have and
//     from the alignment of N and x).  The register file is slot-major in
//     planes of up to four floats, one column a thread
//     (`regs[(slot * planes + p) * blockDim + tid]`): a warp's access to
//     one plane is 32 consecutive 16-byte words, four wavefronts, without
//     bank conflicts.  Inputs and outputs move as 16-byte loads and stores.
//     The interpreter's cost is per warp and per instruction (decode and
//     dispatch), so more work-items a thread spread it: on an H100 the
//     paper's programs ran fastest at 8 a thread in blocks of 128
//     (benchmarks/torch_kernel_times.py --alternatives).
//   - One 16-byte instruction word per instruction, packed at staging as
//     (op | port << 8 | flags << 16, dst | a << 16, b | c << 16, imm bits):
//     the interpreter reads one broadcast LDS.128 per instruction, and then
//     only the operands the opcode uses.
//   - Forwarding.  Compiled programs are chains: most instructions read
//     the result of the one before, and most results are read by nothing
//     else.  The interpreter keeps the last result in registers; staging
//     flags each operand that names the previous instruction's destination
//     (read from registers, not shared memory) and each result that a
//     later instruction, other than through forwarding, or an output needs
//     (only those are stored).
//   - A grid of as many blocks as the SMs hold at once walks tiles of
//     blockDim * W work-items; instructions are staged once per block.
//     Four W-float registers a thread hold the inputs of the next D tiles
//     (D = 4, 2 or 1 for up to 1, 2 or 4 inputs; further inputs load in
//     place), loaded before the interpreter runs on the current tile, so
//     the loads of several tiles stay in flight under the interpreter.
// Tried on an H100 and slower (PERF.md): input stages in shared memory
// (cp.async), which take shared memory from the register file so fewer
// warps fit on an SM; and a branch-free datapath in place of the opcode
// switch, whose selects on every work-item cost more than the branches.
//   - Slots start at zero for every work-item.  At staging the block finds
//     the slots that some instruction may read before any writes them (and
//     output slots never written), and only those are zeroed per tile.
// Every thread reads and writes only its own column, so the instruction loop
// needs no barrier.  The opcode is the same for every thread, so the switch
// never diverges.  Threads past N compute on zeros and store nothing, so N
// is never padded.
//
// Numerics: bit-exact against numpy.  Every op rounds once, as numpy does:
// the fused ops use __fmul_rn / __fadd_rn / __fsub_rn, which the compiler
// never contracts into an FMA (the build also passes -fmad=false).  No fast
// math, so denormals are kept.  MIN and MAX follow np.minimum/np.maximum
// (NaN propagates; on a tie the second operand is kept), which fminf/fmaxf
// do not.

#include <cuda_runtime.h>

namespace {

enum Op : int {
  OP_NOP = 0, OP_ADD, OP_SUB, OP_RSUB, OP_MUL, OP_MULADD, OP_MULSUB,
  OP_IMULADD, OP_IMULSUB, OP_PASS, OP_ABS, OP_NEG, OP_MIN, OP_MAX
};

__device__ __forceinline__ float np_minimum(float a, float b) {
  return (a < b || isnan(a)) ? a : b;
}

__device__ __forceinline__ float np_maximum(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

// The register operands an opcode reads: bit 0 a, bit 1 b, bit 2 c; an
// immediate port takes the place of b (port 1) or c (port 2).
__device__ __forceinline__ unsigned operands(unsigned op, unsigned port) {
  unsigned m;
  switch (op) {
    case OP_NOP: m = 0; break;
    case OP_PASS: case OP_ABS: case OP_NEG: m = 1; break;
    case OP_MULADD: case OP_MULSUB: m = 7; break;
    default: m = 3; break;   // the binary ops, IMULADD and IMULSUB
  }
  if (port == 1) m &= ~2u;
  if (port == 2) m &= ~4u;
  return m;
}

// W work-items of one slot
template <int W>
struct alignas(4 * W) Lanes {
  float v[W];
};

template <int W>
__device__ __forceinline__ Lanes<W> splat(float f) {
  Lanes<W> r;
#pragma unroll
  for (int j = 0; j < W; ++j) r.v[j] = f;
  return r;
}

// registers of W floats a thread that hold inputs loaded ahead
constexpr int AHEAD = 4;
// flags of the instruction word (bits 16-19 of its first field)
constexpr unsigned FWD_A = 1, FWD_B = 2, FWD_C = 4, STORE = 8;

template <int W>
__device__ __forceinline__ Lanes<W> load(const float* p) {
  Lanes<W> r;
  if constexpr (W >= 4) {
#pragma unroll
    for (int h = 0; h < W; h += 4) {
      const float4 q = __ldcs(reinterpret_cast<const float4*>(p + h));
      r.v[h] = q.x; r.v[h + 1] = q.y; r.v[h + 2] = q.z; r.v[h + 3] = q.w;
    }
  } else if constexpr (W == 2) {
    const float2 q = __ldcs(reinterpret_cast<const float2*>(p));
    r.v[0] = q.x; r.v[1] = q.y;
  } else {
    r.v[0] = __ldcs(p);
  }
  return r;
}

template <int W>
__device__ __forceinline__ void store(float* p, const Lanes<W>& r) {
  if constexpr (W >= 4)
#pragma unroll
    for (int h = 0; h < W; h += 4)
      __stcs(reinterpret_cast<float4*>(p + h),
             make_float4(r.v[h], r.v[h + 1], r.v[h + 2], r.v[h + 3]));
  else if constexpr (W == 2)
    __stcs(reinterpret_cast<float2*>(p), make_float2(r.v[0], r.v[1]));
  else
    __stcs(p, r.v[0]);
}

// A thread's column of the register file.  Slot s holds W floats as
// W / V planes of V = min(W, 4) floats, plane p at base[(s * P + p) * bd],
// so a warp's access to one plane is one conflict-free 16-byte load or
// store per thread.
template <int W>
struct Column {
  static constexpr int V = W < 4 ? W : 4, P = W / V;
  Lanes<V>* base;
  int bd;

  __device__ __forceinline__ Lanes<W> get(unsigned s) const {
    Lanes<W> r;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const Lanes<V> q = base[(s * P + p) * bd];
#pragma unroll
      for (int j = 0; j < V; ++j) r.v[p * V + j] = q.v[j];
    }
    return r;
  }

  __device__ __forceinline__ void put(unsigned s, const Lanes<W>& r) const {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      Lanes<V> q;
#pragma unroll
      for (int j = 0; j < V; ++j) q.v[j] = r.v[p * V + j];
      base[(s * P + p) * bd] = q;
    }
  }
};

// One pass of the program over one tile, in this thread's column.
template <int W>
__device__ __forceinline__ void interpret(const uint4* words, int n_instr,
                                          const Column<W>& col) {
  using L = Lanes<W>;
  L prev = L{};                          // the last instruction's result
  uint4 next = n_instr > 0 ? words[0] : uint4{};
  for (int k = 0; k < n_instr; ++k) {
    // the next word is read before this instruction's store, so its load
    // is off the chain of dependent shared-memory accesses
    const uint4 wd = next;
    if (k + 1 < n_instr) next = words[k + 1];
    const unsigned op = wd.x & 0xffu, port = (wd.x >> 8) & 0xffu;
    const unsigned fl = wd.x >> 16;
    const float imm = __uint_as_float(wd.w);
    const L a = (op == OP_NOP || (fl & FWD_A)) ? prev : col.get(wd.y >> 16);
    auto b = [&]() {
      return port == 1 ? splat<W>(imm)
                       : (fl & FWD_B) ? prev : col.get(wd.z & 0xffffu);
    };
    auto c = [&]() {
      return port == 2 ? splat<W>(imm)
                       : (fl & FWD_C) ? prev : col.get(wd.z >> 16);
    };
    L r;
    switch (op) {
      case OP_NOP: r = splat<W>(imm); break;
      case OP_ADD: { const L vb = b();
#pragma unroll
        for (int j = 0; j < W; ++j) r.v[j] = __fadd_rn(a.v[j], vb.v[j]);
      } break;
      case OP_SUB: { const L vb = b();
#pragma unroll
        for (int j = 0; j < W; ++j) r.v[j] = __fsub_rn(a.v[j], vb.v[j]);
      } break;
      case OP_RSUB: { const L vb = b();
#pragma unroll
        for (int j = 0; j < W; ++j) r.v[j] = __fsub_rn(vb.v[j], a.v[j]);
      } break;
      case OP_MUL: { const L vb = b();
#pragma unroll
        for (int j = 0; j < W; ++j) r.v[j] = __fmul_rn(a.v[j], vb.v[j]);
      } break;
      case OP_MULADD: { const L vb = b(), vc = c();
#pragma unroll
        for (int j = 0; j < W; ++j)
          r.v[j] = __fadd_rn(__fmul_rn(a.v[j], vb.v[j]), vc.v[j]);
      } break;
      case OP_MULSUB: { const L vb = b(), vc = c();
#pragma unroll
        for (int j = 0; j < W; ++j)
          r.v[j] = __fsub_rn(__fmul_rn(a.v[j], vb.v[j]), vc.v[j]);
      } break;
      // imuladd/imulsub read the immediate through their own semantics
      case OP_IMULADD: { const L vb = b();
#pragma unroll
        for (int j = 0; j < W; ++j)
          r.v[j] = __fadd_rn(__fmul_rn(a.v[j], imm), vb.v[j]);
      } break;
      case OP_IMULSUB: { const L vb = b();
#pragma unroll
        for (int j = 0; j < W; ++j)
          r.v[j] = __fsub_rn(__fmul_rn(a.v[j], imm), vb.v[j]);
      } break;
      case OP_PASS: r = a; break;
      case OP_ABS:
#pragma unroll
        for (int j = 0; j < W; ++j) r.v[j] = fabsf(a.v[j]);
        break;
      case OP_NEG:
#pragma unroll
        for (int j = 0; j < W; ++j) r.v[j] = -a.v[j];
        break;
      case OP_MIN: { const L vb = b();
#pragma unroll
        for (int j = 0; j < W; ++j) r.v[j] = np_minimum(a.v[j], vb.v[j]);
      } break;
      case OP_MAX: { const L vb = b();
#pragma unroll
        for (int j = 0; j < W; ++j) r.v[j] = np_maximum(a.v[j], vb.v[j]);
      } break;
      default: r = splat<W>(__int_as_float(0x7fc00000)); break;  // rejected
    }
    if (fl & STORE) col.put(wd.y & 0xffffu, r);
    prev = r;
  }
}

// Whether instruction k reads `slot` (through the operands its opcode
// uses) in the rows of `instrs`.
__device__ __forceinline__ bool reads(const int* r, int slot) {
  const unsigned m = operands(r[0], r[5]);
  return ((m & 1) && r[2] == slot) || ((m & 2) && r[3] == slot) ||
         ((m & 4) && r[4] == slot);
}

// The word of instruction k: its fields, the operands forwarded from
// instruction k - 1 and whether its result must be stored.
__device__ uint4 stage_word(const int* instrs, const float* imms, int k,
                            int n_instr, int n_regs, int n_out) {
  const int* r = instrs + 6 * k;
  const unsigned m = operands(r[0], r[5]);
  unsigned fl = 0;
  if (k > 0) {
    const int prev = instrs[6 * (k - 1) + 1];
    if ((m & 1) && r[2] == prev) fl |= FWD_A;
    if ((m & 2) && r[3] == prev) fl |= FWD_B;
    if ((m & 4) && r[4] == prev) fl |= FWD_C;
  }
  // stored when it is an output, or a later instruction but the next (which
  // forwards it) reads it before the slot is written again
  const int dst = r[1];
  bool store = dst >= n_regs - n_out;
  for (int j = k + 1; j < n_instr && !store; ++j) {
    const int* q = instrs + 6 * j;
    if (j > k + 1 && reads(q, dst)) store = true;
    if (q[1] == dst) break;
  }
  if (store) fl |= STORE;
  return make_uint4((unsigned)r[0] | (unsigned)r[5] << 8 | fl << 16,
                    (unsigned)r[1] | (unsigned)r[2] << 16,
                    (unsigned)r[3] | (unsigned)r[4] << 16,
                    __float_as_uint(imms[k]));
}

// Shared memory: n_instr instruction words, the register file
// (n_regs x blockDim columns of W floats, see Column), then the count and
// list of the slots zeroed per tile (n_regs + 1 ints).
template <int W, int D>
__global__ void __launch_bounds__(256) overlay_exec_kernel(
    const int* __restrict__ instrs, const float* __restrict__ imms,
    const float* __restrict__ x, float* __restrict__ out, long long n,
    int n_in, int n_out, int n_instr, int n_regs) {
  using L = Lanes<W>;
  extern __shared__ uint4 smem[];
  const int bd = blockDim.x;
  const int tid = threadIdx.x;
  uint4* words = smem;
  L* regs = reinterpret_cast<L*>(words + n_instr);
  int* zeroed = reinterpret_cast<int*>(regs + n_regs * bd);

  for (int k = tid; k < n_instr; k += bd)
    words[k] = stage_word(instrs, imms, k, n_instr, n_regs, n_out);
  if (tid == 0) zeroed[0] = 0;
  __syncthreads();
  // a slot past the inputs is zeroed per tile when an instruction may read
  // it before any writes it, or when it is an output no instruction writes
  for (int s = n_in + tid; s < n_regs; s += bd) {
    bool zero = s >= n_regs - n_out;
    for (int k = 0; k < n_instr; ++k) {
      const int* r = instrs + 6 * k;
      if (reads(r, s)) {
        zero = true;
        break;
      }
      if (r[1] == s) {
        zero = false;
        break;
      }
    }
    if (zero) zeroed[1 + atomicAdd(zeroed, 1)] = s;
  }
  __syncthreads();
  const int n_zeroed = zeroed[0];

  const long long per_tile = (long long)bd * W;
  const long long n_tiles = (n + per_tile - 1) / per_tile;
  const long long step = gridDim.x;
  const Column<W> col{
      reinterpret_cast<Lanes<Column<W>::V>*>(regs) + tid, bd};
  // inputs of the next D tiles: tile t + d * step in ahead[d]
  constexpr int IN = AHEAD / D;
  L ahead[D][IN];
  auto fetch = [&](long long tile, L (&buf)[IN]) {
    const long long base = tile * per_tile + (long long)tid * W;
#pragma unroll
    for (int i = 0; i < IN; ++i)
      if (i < n_in)
        buf[i] = (tile < n_tiles && base < n) ? load<W>(x + i * n + base)
                                              : splat<W>(0.0f);
  };
#pragma unroll
  for (int d = 0; d < D; ++d) fetch(blockIdx.x + d * step, ahead[d]);

  for (long long t0 = blockIdx.x; t0 < n_tiles; t0 += D * step) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const long long t = t0 + d * step;
      if (t >= n_tiles) break;
      const long long base = t * per_tile + (long long)tid * W;
      const bool live = base < n;        // N % W == 0: all W items or none
#pragma unroll
      for (int i = 0; i < IN; ++i)
        if (i < n_in) col.put(i, ahead[d][i]);
      for (int i = IN; i < n_in; ++i)
        col.put(i, live ? load<W>(x + i * n + base) : splat<W>(0.0f));
      fetch(t + D * step, ahead[d]);
      for (int z = 1; z <= n_zeroed; ++z)
        col.put(zeroed[z], splat<W>(0.0f));

      interpret<W>(words, n_instr, col);

      // outputs live in the last n_out slots (execution-image layout)
      if (live)
        for (int j = 0; j < n_out; ++j)
          store<W>(out + j * n + base, col.get(n_regs - n_out + j));
    }
  }
}

using Kernel = void (*)(const int*, const float*, const float*, float*,
                        long long, int, int, int, int);

template <int W>
Kernel select_depth(int depth) {
  switch (depth) {
    case 4: return overlay_exec_kernel<W, 4>;
    case 2: return overlay_exec_kernel<W, 2>;
    case 1: return overlay_exec_kernel<W, 1>;
    default: return nullptr;
  }
}

// The instance of `items` work-items a thread and `depth` tiles ahead.
Kernel select(int items, int depth) {
  switch (items) {
    case 8: return select_depth<8>(depth);
    case 4: return select_depth<4>(depth);
    case 2: return select_depth<2>(depth);
    case 1: return select_depth<1>(depth);
    default: return nullptr;
  }
}

// Opt the instance in to `smem` bytes of dynamic shared memory.
cudaError_t allow_smem(Kernel k, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute((const void*)k,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

// What the launch plan needs of `device`: the dynamic shared memory one
// block may opt in to, and the SM count.
extern "C" int overlay_exec_device_limits(int device, int* smem_optin,
                                          int* n_sm) {
  cudaError_t e = cudaDeviceGetAttribute(
      smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, device);
  return (int)e;
}

// The blocks of the (items, depth) instance one SM holds at once with
// `block` threads and `smem` bytes of dynamic shared memory, for the grid.
extern "C" int overlay_exec_blocks_per_sm(int items, int depth, int block,
                                          size_t smem, int* blocks_per_sm) {
  const Kernel k = select(items, depth);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(k, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, (const void*)k, block, smem);
}

// Launches the executor on `stream` and returns cudaGetLastError(); it never
// synchronises and allocates nothing.  `out` is (n_out, n) float32, `x` is
// (n_in, n) float32, both contiguous; `items` work-items a thread (4, 2 or
// 1, dividing n, with x and out aligned to 4 * items bytes), `depth` tiles
// loaded ahead (4, 2 or 1), `block` threads, `grid` blocks and `smem` bytes
// of dynamic shared memory come from the wrapper's launch plan.
extern "C" int overlay_exec_launch(const int* instrs, const float* imms,
                                   const float* x, float* out, long long n,
                                   int n_in, int n_out, int n_instr,
                                   int n_regs, int items, int depth,
                                   int block, int grid, size_t smem,
                                   void* stream) {
  const Kernel k = select(items, depth);
  if (k == nullptr || n % items != 0 || block > 256)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(k, smem);
  if (e != cudaSuccess) return (int)e;
  k<<<grid, block, smem, (cudaStream_t)stream>>>(
      instrs, imms, x, out, n, n_in, n_out, n_instr, n_regs);
  return (int)cudaGetLastError();
}

// Name of a CUDA error code, for the wrapper's exception text.
extern "C" const char* overlay_exec_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
