"""Overlay architecture model (paper §III, Fig. 1).

An island-style W×H array of tiles; each tile holds one DSP-block FU
(1 or 2 DSP primitives), a switch box and connection boxes.  Data moves on
registered 16/32-bit point-to-point channels — ``channel_width`` wires per
direction per tile edge, full-crossbar switch boxes.  Kernel I/O enters and
leaves through perimeter IO blocks (the paper's replication experiments are
"limited only by the available I/O").

The routing abstraction used by the PathFinder router: a directed grid graph
whose edges are tile-edge channel bundles with capacity ``channel_width``;
one hop costs one clock (links are registered), which feeds latency
balancing.  This matches the granularity at which VPR sees the paper's
overlay (FUs, 16-bit buses) rather than LUT-level wires.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Tuple

Coord = Tuple[int, int]


@dataclasses.dataclass(frozen=True)
class OverlaySpec:
    """Static description of one overlay instance on the fabric.

    This is what the OpenCL runtime exposes to the JIT compiler (paper §IV):
    geometry + FU type, from which the compiler derives the replication
    factor.
    """

    width: int = 8
    height: int = 8
    dsp_per_fu: int = 2
    channel_width: int = 4          # wires per direction per edge
    fu_latency: int = 4             # DSP pipeline stages per primitive op
    max_delay: int = 63             # delay-chain depth per FU input
    io_per_edge_tile: int = 2       # IO pads per perimeter tile
    word_bits: int = 32
    fclk_mhz: float = 300.0         # paper: overlay Fmax 300 MHz on Zynq

    # ------------------------------------------------------------ geometry
    @property
    def n_fus(self) -> int:
        return self.width * self.height

    @property
    def n_io(self) -> int:
        return 2 * (self.width + self.height) * self.io_per_edge_tile

    @property
    def fu_ports(self) -> int:
        # a 2-DSP FU chain exposes up to 4 external operand ports; 1-DSP: 3
        return 3 if self.dsp_per_fu == 1 else 4

    def tiles(self) -> Iterable[Coord]:
        for y in range(self.height):
            for x in range(self.width):
                yield (x, y)

    def io_sites(self) -> List[Coord]:
        """Perimeter IO sites as virtual coords just outside the grid."""
        sites: List[Coord] = []
        for x in range(self.width):
            sites += [(x, -1)] * self.io_per_edge_tile
            sites += [(x, self.height)] * self.io_per_edge_tile
        for y in range(self.height):
            sites += [(-1, y)] * self.io_per_edge_tile
            sites += [(self.width, y)] * self.io_per_edge_tile
        return sites

    # ------------------------------------------------------- peak numbers
    def peak_gops(self) -> float:
        """Peak throughput: every FU does dsp_per_fu ops/cycle (paper: 115
        GOPS for 8×8×2-DSP at 300 MHz would need ~190 FUs; the Zynq number
        comes from a larger array — we report for *this* spec)."""
        return self.n_fus * self.dsp_per_fu * self.fclk_mhz * 1e6 / 1e9

    def config_bits(self) -> int:
        """Bits to fully configure the overlay (cf. paper's 1061 bytes)."""
        per_tile = _tile_config_bits(self)
        return self.n_fus * per_tile + self.n_io * 8

    def scaled(self, width: int, height: int) -> "OverlaySpec":
        return dataclasses.replace(self, width=width, height=height)


def _tile_config_bits(spec: OverlaySpec) -> int:
    opcode = 5
    imm = spec.word_bits
    # per FU input port: source select among (4 dirs × CW wires + const) and
    # a delay-chain count
    per_port = _ceil_log2(4 * spec.channel_width + 1) + _ceil_log2(
        spec.max_delay + 1)
    ports = spec.fu_ports * per_port
    # switch box: each outgoing wire (4 dirs × CW) selects among incoming
    # (3 other dirs × CW + FU out)
    sbox = 4 * spec.channel_width * _ceil_log2(3 * spec.channel_width + 2)
    return opcode + imm + ports + sbox


def _ceil_log2(n: int) -> int:
    b = 0
    while (1 << b) < n:
        b += 1
    return b


class RoutingGraph:
    """Directed routing-resource graph at channel-bundle granularity.

    Nodes are tile coords (FU sites) plus perimeter IO coords.  Edges connect
    4-neighbour tiles (and perimeter IOs to their adjacent tile), each with
    capacity ``channel_width`` (or io_per_edge_tile for IO edges).  PathFinder
    negotiates congestion on these edges.
    """

    def __init__(self, spec: OverlaySpec):
        self.spec = spec
        self.adj: Dict[Coord, List[Coord]] = {}
        self.capacity: Dict[Tuple[Coord, Coord], int] = {}
        w, h, cw = spec.width, spec.height, spec.channel_width
        for x in range(w):
            for y in range(h):
                self.adj.setdefault((x, y), [])
                for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                    nx, ny = x + dx, y + dy
                    if 0 <= nx < w and 0 <= ny < h:
                        self._edge((x, y), (nx, ny), cw)
        # perimeter IO ↔ adjacent tile
        for x in range(w):
            self._io_edges((x, -1), (x, 0))
            self._io_edges((x, h), (x, h - 1))
        for y in range(h):
            self._io_edges((-1, y), (0, y))
            self._io_edges((w, y), (w - 1, y))

    def _edge(self, a: Coord, b: Coord, cap: int) -> None:
        self.adj.setdefault(a, [])
        if b not in self.adj[a]:
            self.adj[a].append(b)
        self.capacity[(a, b)] = cap

    def _io_edges(self, io: Coord, tile: Coord) -> None:
        cap = self.spec.io_per_edge_tile * 2
        self._edge(io, tile, cap)
        self._edge(tile, io, cap)

    def neighbours(self, n: Coord) -> List[Coord]:
        return self.adj.get(n, [])
