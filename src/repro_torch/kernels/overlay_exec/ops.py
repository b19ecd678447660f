"""Wrapper around the overlay-executor CUDA kernel.

``build_image`` lowers an OverlayProgram to the executor's canonical
execution image: instructions plus final PASS moves that park each output in
the last ``n_out`` register slots.  The CUDA kernel takes every size at run
time, so any image runs on the one build; programs padded to the same
(n_instr, n_regs, n_out) signature can further share one resident
:class:`ExecImage`, and swapping kernels is a write into its buffers.

Where the JAX package picked a block from a TPU VMEM budget and padded N to
a multiple of it, :func:`~repro_torch.kernels.overlay_exec.kernel.plan`
picks the work-items a thread and the block from the shared-memory limit
and the alignment of N and x, and the kernel masks the ragged end of N
instead of padding it.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.program import OP_PASS, OverlayProgram
from repro_torch.device import DeviceLike, to_tensors
from repro_torch.kernels.overlay_exec.kernel import ExecImage, overlay_execute


def build_image(program: OverlayProgram, pad_to: int = 0,
                pad_regs: int = 0) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """→ (instrs (M,6) i32, imms (M,) f32, n_regs_total, n_out)."""
    p = program
    n_out = len(p.out_slots)
    # layout: [program regs | (pad gap) | trash | outputs] — outputs always
    # occupy the LAST n_out slots (the executor's contract); trash absorbs
    # padding NOPs.  pad_regs unifies register-file size across programs so
    # swapped kernels share one resident ExecImage.
    n_regs = max(p.n_regs + 1 + n_out, pad_regs)
    if pad_regs and pad_regs < p.n_regs + 1 + n_out:
        raise ValueError("pad_regs smaller than program register file")
    out_base = n_regs - n_out
    trash = out_base - 1
    moves = [[OP_PASS, out_base + j, s, 0, 0, 0]
             for j, s in enumerate(p.out_slots)]
    instrs = np.concatenate(
        [p.instrs.reshape(-1, 6),
         np.asarray(moves, np.int32).reshape(-1, 6)], axis=0)
    imms = np.concatenate([p.imms, np.zeros((len(moves),), np.float32)])
    if pad_to:
        if pad_to < instrs.shape[0]:
            raise ValueError("pad_to smaller than program")
        extra = pad_to - instrs.shape[0]
        pad_rows = np.tile(np.asarray([[0, trash, 0, 0, 0, 0]], np.int32),
                           (extra, 1))
        instrs = np.concatenate([instrs, pad_rows], axis=0)
        imms = np.concatenate([imms, np.zeros((extra,), np.float32)])
    return instrs, imms, n_regs, n_out


def load_image(program: OverlayProgram, device, pad_to: int = 0,
               pad_regs: int = 0) -> ExecImage:
    """:func:`build_image`, validated and resident on ``device``."""
    instrs, imms, n_regs, n_out = build_image(program, pad_to=pad_to,
                                              pad_regs=pad_regs)
    return ExecImage.from_arrays(instrs, imms, n_regs, n_out, device)


def execute(program: OverlayProgram, inputs: Sequence, *, pad_to: int = 0,
            pad_regs: int = 0, device: DeviceLike = None
            ) -> List[torch.Tensor]:
    """Run an OverlayProgram over flat work-item arrays.  Accepts any
    shaped arrays (work-items = flattened elements) and returns float32
    tensors of the first input's shape, on the device the call runs on:
    ``device``, else the inputs' device, else the CUDA card."""
    xs = to_tensors(inputs, device)
    shape = xs[0].shape
    x = torch.stack([t.reshape(-1) for t in xs])      # (n_in, N)
    image = load_image(program, x.device, pad_to=pad_to, pad_regs=pad_regs)
    out = overlay_execute(image, x)
    return [out[j].reshape(shape) for j in range(image.n_out)]
