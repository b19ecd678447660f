"""VPR-style simulated-annealing placement of the FU netlist (paper §III-D).

Maps SuperNodes (FUs) to overlay tiles and kernel I/O to perimeter IO sites,
minimising total half-perimeter bounding-box wirelength — the same cost VPR
uses.  Deterministic given the seed, so configs are reproducible artifacts.

Two annealers live here:

  * :func:`place` — the original joint annealer that places all R replicas at
    once on the full fabric (kept for parity testing and as the fallback when
    template stamping cannot reach the planned replica count);
  * :func:`anneal_single` — the single-replica annealer used by the
    template-stamping pipeline (:mod:`repro_torch.core.template`).  Its hot loop is
    vectorized: net endpoints are precomputed into numpy index arrays and the
    cost delta of a move is evaluated as one batched numpy expression over
    the moved keys' incident nets instead of a python loop per net.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.faults import fault_point
from repro_torch.core.fuse import FUGraph
from repro_torch.core.overlay import Coord, OverlaySpec


def _pack_map(m: Dict[tuple, Any]) -> Optional[tuple]:
    """A dict of int-tuple keys to ints or int tuples as one array of the
    narrowest int type that holds it (a row an entry, in the dict's order),
    or None where the dict holds anything that would not come back equal."""
    if not m:
        return None
    k0, v0 = next(iter(m.items()))
    if not isinstance(k0, tuple):
        return None
    klen, vtuple = len(k0), isinstance(v0, tuple)
    try:
        rows = np.array([k + v if vtuple else k + (v,)
                         for k, v in m.items()], np.int64)
    except (TypeError, ValueError, OverflowError):
        return None
    for dt in (np.int16, np.int32):
        info = np.iinfo(dt)
        if rows.size and info.min <= rows.min() and rows.max() <= info.max:
            rows = rows.astype(dt)
            break
    packed = (rows, klen, vtuple)
    return packed if rows.ndim == 2 and _unpack_map(*packed) == m else None


def _unpack_map(rows, klen: int, vtuple: bool) -> dict:
    if vtuple:
        return {tuple(r[:klen]): tuple(r[klen:]) for r in rows.tolist()}
    return {tuple(r[:klen]): r[klen] for r in rows.tolist()}


class PackedMaps:
    """Pickles the dict fields named in ``_MAPS`` as int arrays and rebuilds
    them on first read, as :class:`~repro_torch.core.route.RoutingResult`
    does its nets: a disk-cache warm load builds none of their per-entry
    tuples unless something reads them (the serving path runs only the
    bitstream and program)."""

    _MAPS: Tuple[str, ...] = ()

    def __getstate__(self):
        state = dict(self.__dict__)
        packed = state.pop("_packed", {})
        for name in self._MAPS:
            if name in state:
                p = _pack_map(state[name])
                if p is not None:
                    packed[name] = p
                    del state[name]
        if packed:
            state["_packed"] = packed
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)

    def __getattr__(self, name: str):
        packed = self.__dict__.get("_packed")
        if packed is None or name not in packed:
            raise AttributeError(name)
        # the first reader's dicts stand, should two threads race here
        for k, p in packed.items():
            self.__dict__.setdefault(k, _unpack_map(*p))
        self.__dict__.pop("_packed", None)
        return self.__dict__[name]


@dataclasses.dataclass
class Placement(PackedMaps):
    _MAPS = ("fu_pos", "in_pos", "out_pos")

    fu_pos: Dict[Tuple[int, int], Coord]    # (replica, sid) -> tile
    in_pos: Dict[Tuple[int, int], Coord]    # (replica, invar idx) -> io site
    out_pos: Dict[Tuple[int, int], Coord]   # (replica, outvar idx) -> io site
    cost: float
    moves: int


class PlacementError(RuntimeError):
    pass


def _nets(fug: FUGraph, replica: int):
    """Edges as (src key, dst key) with keys ('fu'|'in'|'out', replica, id)."""
    for skind, sid, dkind, did, _port in fug.edges:
        yield (skind, replica, sid), (dkind, replica, did)


def place(fug: FUGraph, spec: OverlaySpec, replicas: int = 1,
          seed: int = 0, effort: float = 1.0) -> Placement:
    """Anneal all replicas jointly onto one overlay."""
    # chaos boundary (repro_torch.core.faults): keyed on the kernel name so plans
    # can target e.g. only fused partitions (their names join with '+')
    fault_point("place", fug.dfg.name)
    rng = random.Random(seed)
    n_fu_sites = spec.n_fus
    need_fu = fug.n_fus * replicas
    if need_fu > n_fu_sites:
        raise PlacementError(
            f"{need_fu} FUs > {n_fu_sites} sites on {spec.width}x{spec.height}")
    io_sites = spec.io_sites()
    need_in = fug.n_in * replicas
    need_out = fug.n_out * replicas
    if need_in + need_out > len(io_sites):
        raise PlacementError(
            f"I/O demand {need_in + need_out} > {len(io_sites)} pads")

    # ---- initial placement: row-major FU scatter, IO round-robin
    tiles = [(x, y) for y in range(spec.height) for x in range(spec.width)]
    rng.shuffle(tiles)
    fu_keys = [(r, s.sid) for r in range(replicas) for s in fug.supers]
    fu_pos = {k: tiles[i] for i, k in enumerate(fu_keys)}
    free_tiles = tiles[len(fu_keys):]

    io_order = list(io_sites)
    rng.shuffle(io_order)
    in_keys = [(r, i) for r in range(replicas) for i in range(fug.n_in)]
    out_keys = [(r, i) for r in range(replicas) for i in range(fug.n_out)]
    in_pos = {k: io_order[i] for i, k in enumerate(in_keys)}
    out_pos = {k: io_order[len(in_keys) + i] for i, k in enumerate(out_keys)}
    free_io = io_order[len(in_keys) + len(out_keys):]

    nets: List[Tuple[Tuple, Tuple]] = []
    for r in range(replicas):
        nets.extend(_nets(fug, r))

    def pos_of(key) -> Coord:
        kind, r, i = key
        if kind == "fu":
            return fu_pos[(r, i)]
        if kind == "in":
            return in_pos[(r, i)]
        return out_pos[(r, i)]

    def net_cost(net) -> float:
        (a, b) = net
        ax, ay = pos_of(a)
        bx, by = pos_of(b)
        return abs(ax - bx) + abs(ay - by)

    cost = sum(net_cost(n) for n in nets)

    # nets touching each movable key (for incremental delta)
    touching: Dict[Tuple, List[int]] = {}
    for idx, (a, b) in enumerate(nets):
        touching.setdefault(a, []).append(idx)
        touching.setdefault(b, []).append(idx)

    n_moves = int(effort * 200 * max(1, len(fu_keys) + len(in_keys)))
    t = max(4.0, cost / max(1, len(nets)))  # initial temperature
    t_min = 0.005
    alpha = (t_min / t) ** (1.0 / max(1, n_moves))
    moves_done = 0

    def swap_fu(k1, k2=None, j=None):
        """Swap two FUs, or swap k1 with free tile j. Returns cost delta."""
        affected = set(touching.get(("fu",) + k1, []))
        if k2 is not None:
            affected |= set(touching.get(("fu",) + k2, []))
        before = sum(net_cost(nets[i]) for i in affected)
        if k2 is None:
            fu_pos[k1], free_tiles[j] = free_tiles[j], fu_pos[k1]
        else:
            fu_pos[k1], fu_pos[k2] = fu_pos[k2], fu_pos[k1]
        after = sum(net_cost(nets[i]) for i in affected)
        return after - before

    def swap_io(table, k1, free_list):
        kind = "in" if table is in_pos else "out"
        affected = set(touching.get((kind,) + k1, []))
        before = sum(net_cost(nets[i]) for i in affected)
        if free_list and rng.random() < 0.5:
            j = rng.randrange(len(free_list))
            table[k1], free_list[j] = free_list[j], table[k1]
            undo = ("free", j)
        else:
            keys = list(table.keys())
            k2 = keys[rng.randrange(len(keys))]
            table[k1], table[k2] = table[k2], table[k1]
            undo = ("swap", k2)
        after = sum(net_cost(nets[i]) for i in affected)
        return after - before, undo

    for step in range(n_moves):
        roll = rng.random()
        if fu_keys and (roll < 0.7 or not in_keys):
            k1 = fu_keys[rng.randrange(len(fu_keys))]
            use_free = free_tiles and rng.random() < 0.4
            if use_free:
                j = rng.randrange(len(free_tiles))
                delta = swap_fu(k1, None, j)
                if delta <= 0 or rng.random() < math.exp(-delta / t):
                    cost += delta
                    moves_done += 1
                else:
                    swap_fu(k1, None, j)   # swap back: exact inverse
            else:
                k2 = fu_keys[rng.randrange(len(fu_keys))]
                if k2 == k1:
                    continue
                delta = swap_fu(k1, k2)
                if delta <= 0 or rng.random() < math.exp(-delta / t):
                    cost += delta
                    moves_done += 1
                else:
                    swap_fu(k1, k2)        # swap back
        else:
            which = in_pos if (rng.random() < 0.5 and in_keys) or not out_keys \
                else out_pos
            keys = in_keys if which is in_pos else out_keys
            if not keys:
                continue
            k1 = keys[rng.randrange(len(keys))]
            free_list = free_io
            delta, undo = swap_io(which, k1, free_list)
            if delta <= 0 or rng.random() < math.exp(-delta / t):
                cost += delta
                moves_done += 1
            else:
                kind, j_or_k = undo
                if kind == "free":
                    which[k1], free_list[j_or_k] = free_list[j_or_k], which[k1]
                else:
                    which[k1], which[j_or_k] = which[j_or_k], which[k1]
        t *= alpha

    return Placement(dict(fu_pos), dict(in_pos), dict(out_pos),
                     float(cost), moves_done)


# ===================================================== single-replica anneal

@dataclasses.dataclass
class SinglePlacement:
    """One replica placed on explicit site pools (template frame)."""
    fu_pos: Dict[int, Coord]      # sid -> tile
    in_pos: Dict[int, Coord]      # invar idx -> io site
    out_pos: Dict[int, Coord]     # outvar idx -> io site
    cost: float
    moves: int

    def as_placement(self) -> Placement:
        return Placement({(0, s): p for s, p in self.fu_pos.items()},
                         {(0, i): p for i, p in self.in_pos.items()},
                         {(0, i): p for i, p in self.out_pos.items()},
                         self.cost, self.moves)


def anneal_single(fug: FUGraph, tiles: Sequence[Coord],
                  io_sites: Sequence[Coord], seed: int = 0,
                  effort: float = 1.0) -> SinglePlacement:
    """Place ONE replica onto the given tile/IO site pools.

    The caller restricts the pools to a region (e.g. a template strip); every
    FU lands on a distinct tile and every kernel I/O on a distinct IO site
    (sites may repeat in ``io_sites`` up to their physical multiplicity).

    The hot loop is fully vectorized: net endpoints are precomputed into
    numpy weight matrices, and each iteration evaluates the wirelength delta
    of EVERY candidate move at once — an (n_keys × n_slots) relocation-cost
    matrix from one broadcast plus an all-pairs swap-delta matrix — then
    applies the steepest one.  Seeded random restarts (``effort`` many)
    replace the temperature schedule; deterministic given the seed.
    """
    fault_point("place", fug.dfg.name)
    n_fu, n_in, n_out = fug.n_fus, fug.n_in, fug.n_out
    if n_fu > len(tiles):
        raise PlacementError(f"{n_fu} FUs > {len(tiles)} region tiles")
    if n_in + n_out > len(io_sites):
        raise PlacementError(
            f"I/O demand {n_in + n_out} > {len(io_sites)} region pads")
    rng = random.Random(seed)
    n_keys = n_fu + n_in + n_out

    def key_of(kind: str, i: int) -> int:
        return {"fu": 0, "in": n_fu, "out": n_fu + n_in}[kind] + i

    # symmetric net-count matrix between keys (multi-edges accumulate)
    w = np.zeros((n_keys, n_keys), np.float64)
    for sk, si, dk, di, _p in fug.edges:
        a, b = key_of(sk, si), key_of(dk, di)
        w[a, b] += 1.0
        w[b, a] += 1.0

    tiles_arr = np.asarray(tiles, np.float64).reshape(-1, 2)
    pads_arr = np.asarray(io_sites, np.float64).reshape(-1, 2)
    domains = [(np.arange(0, n_fu), tiles_arr),
               (np.arange(n_fu, n_keys), pads_arr)]

    def descend(pos: np.ndarray, slot_of: np.ndarray
                ) -> Tuple[np.ndarray, float, int]:
        """Steepest-descent to a local optimum; returns (pos, cost, moves).
        ``slot_of`` (key → domain-local slot index) is maintained
        incrementally across moves, never recomputed."""
        moves = 0
        improved = True
        while improved:
            improved = False
            for keys, slots in domains:
                if not len(keys):
                    continue
                n, s = len(keys), len(slots)
                # relocation-cost matrix: d[k, t] = wirelength of key k if it
                # sat at slot t, everything else fixed — one broadcast
                dist = np.abs(slots[:, None, :] - pos[None, :, :]).sum(-1)
                d = w[keys] @ dist.T
                occ = slot_of[keys]
                base = d[np.arange(n), occ]
                free = np.ones(s, bool)
                free[occ] = False
                best_delta, best_move = 0.0, None
                if free.any():
                    rel = d[:, free] - base[:, None]
                    k, t = np.unravel_index(np.argmin(rel), rel.shape)
                    if rel[k, t] < -1e-9:
                        best_delta = rel[k, t]
                        best_move = ("free", keys[k],
                                     np.flatnonzero(free)[t])
                if n > 1:
                    # swap-delta matrix; +2·w·dist corrects nets between the
                    # swapped pair (their length is swap-invariant)
                    a = d[:, occ]
                    pair = np.abs(pos[keys][:, None, :] -
                                  pos[keys][None, :, :]).sum(-1)
                    sw = (a + a.T - base[:, None] - base[None, :] +
                          2.0 * w[np.ix_(keys, keys)] * pair)
                    np.fill_diagonal(sw, 0.0)
                    k, l = np.unravel_index(np.argmin(sw), sw.shape)
                    if sw[k, l] < best_delta - 1e-9:
                        best_delta = sw[k, l]
                        best_move = ("swap", keys[k], keys[l])
                if best_move is not None and best_delta < -1e-9:
                    if best_move[0] == "free":
                        _, gk, t = best_move
                        pos[gk] = slots[t]
                        slot_of[gk] = t
                    else:
                        _, gk, gl = best_move
                        pos[[gk, gl]] = pos[[gl, gk]]
                        slot_of[[gk, gl]] = slot_of[[gl, gk]]
                    moves += 1
                    improved = True
        cost = float((w * np.abs(pos[:, None, :] - pos[None, :, :]
                                 ).sum(-1)).sum() / 2.0)
        return pos, cost, moves

    restarts = max(1, int(round(effort)))
    best = None
    for _r in range(restarts):
        tile_order = list(range(len(tiles)))
        rng.shuffle(tile_order)
        pad_order = list(range(len(io_sites)))
        rng.shuffle(pad_order)
        pos = np.empty((n_keys, 2), np.float64)
        pos[:n_fu] = tiles_arr[tile_order[:n_fu]]
        pos[n_fu:] = pads_arr[pad_order[:n_in + n_out]]
        slot_of = np.empty(n_keys, np.int64)
        slot_of[:n_fu] = tile_order[:n_fu]
        slot_of[n_fu:] = pad_order[:n_in + n_out]
        pos, cost, moves = descend(pos, slot_of)
        if best is None or cost < best[1]:
            best = (pos.copy(), cost, moves)
    pos, cost, moves = best

    fu_pos = {s: (int(pos[s][0]), int(pos[s][1])) for s in range(n_fu)}
    in_pos = {i: (int(pos[n_fu + i][0]), int(pos[n_fu + i][1]))
              for i in range(n_in)}
    out_pos = {i: (int(pos[n_fu + n_in + i][0]), int(pos[n_fu + n_in + i][1]))
               for i in range(n_out)}
    return SinglePlacement(fu_pos, in_pos, out_pos, float(cost), moves)

