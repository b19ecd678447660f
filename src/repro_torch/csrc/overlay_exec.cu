// Overlay executor for Hopper (sm_90a): one CUDA thread per work-item runs
// an OverlayProgram, the linearised form of a placed-and-routed overlay
// kernel.
//
// Replaces the Pallas TPU kernel `_exec_kernel`, launched by
// `overlay_execute` (src/repro/kernels/overlay_exec/kernel.py).  Plain
// version: src/repro_torch/kernels/overlay_exec/ref.py::execute_image.
// Binding: src/repro_torch/kernels/overlay_exec/kernel.py (ctypes).
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
// Design.  Each block stages the instructions and immediates in shared
// memory once.  The register file lives in dynamic shared memory, slot-major
// (`regs[slot * blockDim + tid]`), so a warp's accesses to one slot fall in
// 32 distinct banks.  Every thread reads and writes only its own column, so
// the instruction loop needs no barrier.  The opcode is the same for every
// thread, so the switch never diverges.  Inputs `x[i * N + gid]` and outputs
// `out[j * N + gid]` are coalesced; threads past N compute on zeros and store
// nothing, so N is never padded.  The wrapper shrinks the block when the
// register file would not fit the opt-in shared-memory limit.
//
// What bounds it.  Each work-item reads n_in and writes n_out floats: at
// N = 2^24 that is 134-335 MB per launch, which is bound by device memory
// (3.35 TB/s on an H100 SXM).  The interpreter itself costs about 11
// shared-memory accesses per instruction per work-item, which for the
// paper's 5-14 instruction programs is the larger cost; PERF.md holds the
// measured times beside the bound.
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

__global__ void overlay_exec_kernel(const int* __restrict__ instrs,
                                    const float* __restrict__ imms,
                                    const float* __restrict__ x,
                                    float* __restrict__ out, long long n,
                                    int n_in, int n_out, int n_instr,
                                    int n_regs) {
  extern __shared__ float smem[];
  const int bd = blockDim.x;
  const int tid = threadIdx.x;
  float* regs = smem;                                          // [n_regs][bd]
  int* s_instr = reinterpret_cast<int*>(regs + (size_t)n_regs * bd);
  float* s_imm = reinterpret_cast<float*>(s_instr + 6 * n_instr);

  for (int i = tid; i < 6 * n_instr; i += bd) s_instr[i] = instrs[i];
  for (int i = tid; i < n_instr; i += bd) s_imm[i] = imms[i];

  const long long gid = (long long)blockIdx.x * bd + tid;
  const bool live = gid < n;
  // inputs in slots [0, n_in), every other slot starts at 0 as in ref.py
  for (int s = 0; s < n_regs; ++s)
    regs[s * bd + tid] = (live && s < n_in) ? x[(size_t)s * n + gid] : 0.0f;
  __syncthreads();

  for (int k = 0; k < n_instr; ++k) {
    const int* w = s_instr + 6 * k;
    const int op = w[0];
    const int port = w[5];
    const float imm = s_imm[k];
    const float a = regs[w[2] * bd + tid];
    const float b = port == 1 ? imm : regs[w[3] * bd + tid];
    const float c = port == 2 ? imm : regs[w[4] * bd + tid];
    float r;
    switch (op) {
      case OP_NOP: r = imm; break;
      case OP_ADD: r = __fadd_rn(a, b); break;
      case OP_SUB: r = __fsub_rn(a, b); break;
      case OP_RSUB: r = __fsub_rn(b, a); break;
      case OP_MUL: r = __fmul_rn(a, b); break;
      case OP_MULADD: r = __fadd_rn(__fmul_rn(a, b), c); break;
      case OP_MULSUB: r = __fsub_rn(__fmul_rn(a, b), c); break;
      // imuladd/imulsub read the immediate through their own semantics
      case OP_IMULADD: r = __fadd_rn(__fmul_rn(a, imm), b); break;
      case OP_IMULSUB: r = __fsub_rn(__fmul_rn(a, imm), b); break;
      case OP_PASS: r = a; break;
      case OP_ABS: r = fabsf(a); break;
      case OP_NEG: r = -a; break;
      case OP_MIN: r = np_minimum(a, b); break;
      case OP_MAX: r = np_maximum(a, b); break;
      default: r = __int_as_float(0x7fc00000); break;  // rejected by wrapper
    }
    regs[w[1] * bd + tid] = r;
  }

  // outputs live in the last n_out register slots (execution-image layout)
  if (live)
    for (int j = 0; j < n_out; ++j)
      out[(size_t)j * n + gid] = regs[(n_regs - n_out + j) * bd + tid];
}

}  // namespace

// The largest dynamic shared memory one block of `device` may opt in to.
extern "C" int overlay_exec_smem_optin(int device, int* bytes) {
  return (int)cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// Launches the executor on `stream` and returns cudaGetLastError(); it never
// synchronises and allocates nothing.  `out` is (n_out, n) float32, `x` is
// (n_in, n) float32, both contiguous; `block` threads per block and `smem`
// bytes of dynamic shared memory come from the wrapper's launch config.
extern "C" int overlay_exec_launch(const int* instrs, const float* imms,
                                   const float* x, float* out, long long n,
                                   int n_in, int n_out, int n_instr,
                                   int n_regs, int block, size_t smem,
                                   void* stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        overlay_exec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long grid = (n + block - 1) / block;
  overlay_exec_kernel<<<(unsigned)grid, block, smem, (cudaStream_t)stream>>>(
      instrs, imms, x, out, n, n_in, n_out, n_instr, n_regs);
  return (int)cudaGetLastError();
}

// Name of a CUDA error code, for the wrapper's exception text.
extern "C" const char* overlay_exec_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
