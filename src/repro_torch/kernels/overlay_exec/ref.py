"""Plain PyTorch version of the overlay executor.

Interprets the same execution image the CUDA kernel runs: a register file
of (R, N) values, one instruction at a time, on whatever device the inputs
lie.  It restates ``repro/kernels/overlay_exec/ref.py::execute_image`` (the
numpy oracle) operation for operation, so both give the same float32 bits:
every instruction is one separately rounded torch op, ``a*b + c`` included.
:func:`execute` runs an ``OverlayProgram`` on its raw inputs through it,
as the JAX package's ``ref.execute`` does.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from repro_torch.core.dfg import tensor_maximum, tensor_minimum
from repro_torch.core.program import (
    OverlayProgram, OP_ABS, OP_ADD, OP_IMULADD, OP_IMULSUB, OP_MAX, OP_MIN, OP_MUL,
    OP_MULADD, OP_MULSUB, OP_NEG, OP_NOP, OP_PASS, OP_RSUB, OP_SUB)


def _apply(op: int, a, b, c, imm: float):
    if op == OP_NOP:
        return torch.full_like(a, imm)
    if op == OP_ADD:
        return a + b
    if op == OP_SUB:
        return a - b
    if op == OP_RSUB:
        return b - a
    if op == OP_MUL:
        return a * b
    if op == OP_MULADD:
        return a * b + c
    if op == OP_MULSUB:
        return a * b - c
    if op == OP_IMULADD:
        return a * imm + b
    if op == OP_IMULSUB:
        return a * imm - b
    if op == OP_PASS:
        return a
    if op == OP_ABS:
        return torch.abs(a)
    if op == OP_NEG:
        return -a
    if op == OP_MIN:
        return tensor_minimum(a, b)
    if op == OP_MAX:
        return tensor_maximum(a, b)
    raise ValueError(f"bad opcode {op}")


def execute_image(instrs, imms, n_regs: int, inputs: torch.Tensor,
                  n_out: int) -> torch.Tensor:
    """inputs: (n_in, N) float32 → outputs (n_out, N) on the inputs'
    device; output slots are the last ``n_out`` registers (the
    execution-image convention, see ops.py).  ``instrs`` (M, 6) and
    ``imms`` (M,) may be numpy arrays or tensors on any device."""
    rows = np.asarray(torch.as_tensor(instrs).cpu(), np.int64).reshape(-1, 6)
    imm_vals = np.asarray(torch.as_tensor(imms).cpu(), np.float32)
    n_in, n = inputs.shape
    regs = torch.zeros((n_regs, n), dtype=torch.float32, device=inputs.device)
    regs[:n_in] = inputs
    for k in range(rows.shape[0]):
        op, d, a, b, c, imm_port = (int(v) for v in rows[k])
        imm = float(imm_vals[k])
        va, vb, vc = regs[a], regs[b], regs[c]
        if imm_port == 1:
            vb = torch.full_like(va, imm)
        elif imm_port == 2:
            vc = torch.full_like(va, imm)
        regs[d] = _apply(op, va, vb, vc, imm)
    return regs[n_regs - n_out:].clone()



def execute(program: OverlayProgram, inputs: Sequence) -> List[torch.Tensor]:
    """Plain execution of an OverlayProgram on raw (unpadded) inputs, one
    tensor (or array) per input slot, all of one shape → one tensor per
    output slot, of that shape, float32, on the inputs' device (the CPU
    for arrays)."""
    from repro_torch.kernels.overlay_exec.ops import build_image
    ts = [torch.as_tensor(x) for x in inputs]
    arrs = torch.stack([t.to(torch.float32).reshape(-1) for t in ts])
    instrs, imms, n_regs, n_out = build_image(program)
    out = execute_image(instrs, imms, n_regs, arrs, n_out)
    return [out[j].reshape(ts[0].shape) for j in range(n_out)]
