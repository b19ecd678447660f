"""Linearised overlay program — the executable form of a routed kernel.

The FPGA overlay executes the DFG spatially; the GPU executor runs it as a
short instruction sequence per work-item (one CUDA thread each): FU array →
threads, wires → register slots in shared memory.

``OverlayProgram`` is pure data (numpy arrays), so feeding a *new* program to
the already-built CUDA executor is the analogue of the paper's 42 µs partial
reconfiguration — no kernel rebuild.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.dfg import DFG

OP_NOP, OP_ADD, OP_SUB, OP_RSUB, OP_MUL, OP_MULADD, OP_MULSUB, \
    OP_IMULADD, OP_IMULSUB, OP_PASS, OP_ABS, OP_NEG, OP_MIN, OP_MAX = range(14)

OPCODE = {"nop": OP_NOP, "add": OP_ADD, "sub": OP_SUB, "rsub": OP_RSUB,
          "mul": OP_MUL, "muladd": OP_MULADD, "mulsub": OP_MULSUB,
          "imuladd": OP_IMULADD, "imulsub": OP_IMULSUB, "pass": OP_PASS,
          "abs": OP_ABS, "neg": OP_NEG, "min": OP_MIN, "max": OP_MAX}
N_OPCODES = 14


@dataclasses.dataclass
class OverlayProgram:
    """instrs[i] = (opcode, dst, a, b, c, imm_port); imms[i] = f32 immediate.

    imm_port: 0 = no immediate substitution (imuladd/imulsub/nop consume the
    immediate through their own semantics), 1 = operand *b* is the immediate,
    2 = operand *c* is the immediate (fused muladd/mulsub addend).

    Register file: slots [0, n_regs).  Input i is pre-loaded into slot
    in_slots[i]; output j is read from slot out_slots[j].  Unused operand
    fields point at slot 0 (harmless read).
    """
    name: str
    n_regs: int
    instrs: np.ndarray          # (n_instr, 6) int32
    imms: np.ndarray            # (n_instr,) float32
    in_slots: Tuple[int, ...]
    out_slots: Tuple[int, ...]

    @property
    def n_instr(self) -> int:
        return int(self.instrs.shape[0])

    def content_hash(self) -> str:
        """Content hash over everything the executor consumes (instruction
        words, immediates, register map) — the cross-process disk-cache
        round-trip asserts equality on it."""
        import hashlib
        h = hashlib.sha256()
        h.update(self.name.encode())
        h.update(np.int64(self.n_regs).tobytes())
        h.update(np.ascontiguousarray(self.instrs).tobytes())
        h.update(np.ascontiguousarray(self.imms).tobytes())
        h.update(np.asarray(self.in_slots + self.out_slots,
                            np.int64).tobytes())
        return h.hexdigest()

    def padded(self, n: int) -> "OverlayProgram":
        """Pad instruction list with NOPs to length n (fixed-shape executor)."""
        if n < self.n_instr:
            raise ValueError("cannot shrink program")
        pad = n - self.n_instr
        # padding NOPs write imm=0 into a dedicated trash slot so they can
        # never clobber live registers
        trash = self.n_regs
        pad_rows = np.tile(np.asarray([[0, trash, 0, 0, 0, 0]], np.int32),
                           (pad, 1))
        instrs = np.concatenate([self.instrs, pad_rows], axis=0)
        imms = np.concatenate([self.imms, np.zeros((pad,), np.float32)])
        return dataclasses.replace(self, n_regs=self.n_regs + 1,
                                   instrs=instrs, imms=imms)


def compile_program(g: DFG) -> OverlayProgram:
    """DFG → register-allocated linear program (topological order)."""
    slot: Dict[int, int] = {}
    next_slot = 0

    def alloc(nid: int) -> int:
        nonlocal next_slot
        slot[nid] = next_slot
        next_slot += 1
        return slot[nid]

    in_slots = [alloc(nid) for nid in g.inputs]
    rows: List[List[int]] = []
    imms: List[float] = []
    for n in g.toposort():
        if n.op in ("input", "output"):
            continue
        if n.op == "const":
            # OP_NOP doubles as "load immediate": dst = imm
            d = alloc(n.nid)
            rows.append([OP_NOP, d, 0, 0, 0, 0])
            imms.append(float(n.imm))
            continue
        d = alloc(n.nid)
        args = list(n.args) + [0] * (3 - len(n.args))
        a, b, c = (slot.get(x, 0) for x in args)
        imm_port = 0
        if n.imm is not None:
            if n.op in ("add", "sub", "rsub", "mul", "min", "max"):
                imm_port = 1           # imm is operand b
            elif n.op in ("muladd", "mulsub"):
                imm_port = 2           # imm is the addend c
            # imuladd/imulsub read the imm via their own semantics (port 0)
        rows.append([OPCODE[n.op], d, a, b, c, imm_port])
        imms.append(float(n.imm) if n.imm is not None else 0.0)
    out_slots = [slot[g.nodes[o].args[0]] for o in g.outputs]
    instrs = np.asarray(rows, np.int32).reshape(-1, 6)
    return OverlayProgram(g.name, next_slot, instrs,
                          np.asarray(imms, np.float32),
                          tuple(in_slots), tuple(out_slots))


def program_from_arrays(name: str, n_regs: int, instrs, imms,
                        in_slots, out_slots) -> OverlayProgram:
    """An :class:`OverlayProgram` from plain fields (numpy arrays, ints).

    This is how a program compiled elsewhere — for example by the JAX
    package, whose ``OverlayProgram`` has exactly these fields — is carried
    into this package without importing the other package's types."""
    instrs = np.array(instrs, np.int32).reshape(-1, 6)
    imms = np.array(imms, np.float32).reshape(-1)
    if imms.shape[0] != instrs.shape[0]:
        raise ValueError(f"{name}: {instrs.shape[0]} instructions but "
                         f"{imms.shape[0]} immediates")
    return OverlayProgram(str(name), int(n_regs), instrs, imms,
                          tuple(int(s) for s in in_slots),
                          tuple(int(s) for s in out_slots))
