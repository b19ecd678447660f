"""Configuration ("bitstream") generation for the overlay (paper §III-E/IV).

Packs FU opcodes, immediates, port selects, delay-chain counts and switch-box
routes into a flat byte array — the artifact that reconfigures the overlay at
run time (paper: 1061 bytes for the 8×8 overlay, loaded in 42.4 µs vs 4 MB /
31.6 ms for full-fabric reconfiguration).

The packing is deterministic and self-describing enough to be unpacked again,
which the tests use as a round-trip property.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict

from repro_torch.core.fuse import FUGraph
from repro_torch.core.latency import LatencyAssignment
from repro_torch.core.overlay import OverlaySpec
from repro_torch.core.place import Placement
from repro_torch.core.route import RoutingResult

_OPCODE = {op: i for i, op in enumerate((
    "nop", "add", "sub", "rsub", "mul", "muladd", "mulsub", "imuladd",
    "imulsub", "pass", "abs", "neg", "min", "max"))}
_OPNAME = {i: op for op, i in _OPCODE.items()}

MAGIC = 0x4F564C59  # 'OVLY'


@dataclasses.dataclass
class Bitstream:
    data: bytes
    spec: OverlaySpec

    @property
    def n_bytes(self) -> int:
        return len(self.data)

    def load_time_us(self, bw_mbps: float = 25.0) -> float:
        """Config-load time at the paper's ~25 MB/s AXI config rate."""
        return self.n_bytes / bw_mbps

    def sha256(self) -> str:
        """Content hash of the packed configuration — the disk-cache tests
        and the restart benchmark use it to assert a warm-loaded artifact
        is bit-for-bit the one that was persisted."""
        import hashlib
        return hashlib.sha256(self.data).hexdigest()

    def __repr__(self) -> str:
        return (f"Bitstream({self.n_bytes} bytes for "
                f"{self.spec.width}x{self.spec.height} overlay)")


def generate(fug: FUGraph, spec: OverlaySpec, placement: Placement,
             routing: RoutingResult, latency: LatencyAssignment,
             replicas: int) -> Bitstream:
    """Pack the full overlay configuration.

    Layout:
      header: MAGIC, W, H, dsp_per_fu, n_tiles_used, n_routes, replicas
      per used tile:  (x, y, opcode0, opcode1, imm: f32, d0, d1, d2, d3)
      per route:      (n_hops, hops as packed dx/dy nibbles)
      per io:         (x+1, y+1, dir, index)
    """
    out = bytearray()
    out += struct.pack("<IHHBBHH", MAGIC, spec.width, spec.height,
                       spec.dsp_per_fu, replicas & 0xFF,
                       len(placement.fu_pos), len(routing.nets))

    dfg = fug.dfg
    for (rep, sid), (x, y) in sorted(placement.fu_pos.items()):
        s = fug.supers[sid]
        ops = [dfg.nodes[m].op for m in s.members]
        imms = [dfg.nodes[m].imm for m in s.members if dfg.nodes[m].imm is not None]
        op0 = _OPCODE[ops[0]]
        op1 = _OPCODE[ops[1]] if len(ops) > 1 else _OPCODE["nop"]
        imm = imms[0] if imms else 0.0
        ds = [latency.delays.get((rep, sid, p), 0) for p in range(4)]
        if any(d > 255 for d in ds):
            raise ValueError("delay exceeds 8-bit config field")
        out += struct.pack("<BBBBfBBBB", x, y, op0, op1, imm, *ds)

    for net in routing.nets:
        hops = net.path
        out += struct.pack("<H", len(hops))
        for (ax, ay), (bx, by) in zip(hops, hops[1:]):
            # direction nibble: 0=E 1=W 2=N 3=S
            d = {(1, 0): 0, (-1, 0): 1, (0, 1): 2, (0, -1): 3}[(bx - ax, by - ay)]
            out += struct.pack("<B", d)

    for table, kind in ((placement.in_pos, 0), (placement.out_pos, 1)):
        for (rep, idx), (x, y) in sorted(table.items()):
            out += struct.pack("<bbBB", x, y, kind, idx & 0xFF)

    return Bitstream(bytes(out), spec)


def parse_header(bs: Bitstream) -> Dict[str, int]:
    magic, w, h, dsp, reps, tiles, nets = struct.unpack_from("<IHHBBHH", bs.data)
    if magic != MAGIC:
        raise ValueError("bad magic")
    return dict(width=w, height=h, dsp_per_fu=dsp, replicas=reps,
                tiles_used=tiles, nets=nets)
