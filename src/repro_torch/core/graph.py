"""Recorded kernel graphs — OpenCL command-buffer / CUDA-Graph analogue.

The serving pattern the paper's runtime is worst at is *many small kernels
from one tenant*: every switch between their configurations pays the
bitstream charge, so the tenant's timeline fills with reconfigs instead of
exec.  A :class:`KernelGraph` turns that pattern into data the runtime can
optimize: inside ``with session.capture(tenant) as g:`` every
``g.call(source, opts, *buffers)`` is a **recording operation** — no
compile, no enqueue — and the :class:`GraphBuffer` values flowing between
calls define a DAG.  ``session.instantiate`` then *partitions* the DAG
(:func:`partition_graph`), fuses each partition into ONE kernel
(:func:`repro_torch.core.fuse.fuse_dfgs`) whose intermediate buffers are elided,
and compiles it through the normal cached/single-flight pipeline;
``session.launch`` replays the whole graph paying the configuration charge
once per *partition* instead of once per *node*.

The module is runtime-agnostic on purpose: a KernelGraph only needs a
``lower`` callable (source → DFG) — the Session passes one backed by its
frontend cache tier, tests can use the raw
:func:`repro_torch.core.jit.lower_to_dfg`.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cache import dfg_fingerprint
from repro_torch.core.dfg import DFG
from repro_torch.core.fuse import FusionError, fuse_dfgs, to_fu_graph
from repro_torch.core.options import CompileOptions
from repro_torch.core.overlay import OverlaySpec
from repro_torch.core.replicate import plan_replication


class GraphError(ValueError):
    """Malformed graph construction or use (foreign buffers, arity
    mismatches, frozen-graph mutation, cyclic wiring)."""


class GraphBuffer:
    """Symbolic buffer recorded during capture.

    Either a *graph input* placeholder (``kind == "in"``: bound to a real
    array at launch) or the ``out_idx``-th output of node ``nid``
    (``kind == "node"``).  It carries no data — capture records dataflow,
    not values.
    """

    __slots__ = ("graph", "kind", "index", "nid", "out_idx", "name")

    def __init__(self, graph: "KernelGraph", kind: str, index: int = 0,
                 nid: int = 0, out_idx: int = 0, name: str = ""):
        self.graph = graph
        self.kind = kind                 # "in" | "node"
        self.index = index               # graph-input position (kind "in")
        self.nid = nid                   # producing node (kind "node")
        self.out_idx = out_idx           # output slot on that node
        self.name = name

    def ref(self) -> Tuple:
        """Canonical wiring key: ("in", i) or ("node", nid, out_idx)."""
        return ("in", self.index) if self.kind == "in" else \
            ("node", self.nid, self.out_idx)

    def __repr__(self) -> str:
        where = f"in{self.index}" if self.kind == "in" else \
            f"N{self.nid}.{self.out_idx}"
        return f"GraphBuffer({self.graph.name}:{where})"


@dataclasses.dataclass
class GraphNode:
    """One recorded kernel call: the lowered DFG, the build options it was
    recorded with, and the wiring of its inputs."""
    nid: int
    source: object                        # what the caller passed (for repr)
    dfg: DFG
    opts: CompileOptions
    args: Tuple[GraphBuffer, ...]

    @property
    def n_outputs(self) -> int:
        return len(self.dfg.outputs)


class KernelGraph:
    """A recorded DAG of kernel calls (see module docstring).

    >>> with session.capture("tenant-a") as g:
    ...     x = g.input("x")
    ...     t = g.call(STAGE1_SRC, opts, x)
    ...     y = g.call(STAGE2_SRC, opts, t)
    ... # g is now frozen: leaves ([y]) are the graph outputs
    """

    def __init__(self, name: str = "graph", tenant: Optional[str] = None,
                 lower: Optional[Callable] = None):
        self.name = name
        self.tenant = tenant
        self.inputs: List[GraphBuffer] = []
        self.nodes: List[GraphNode] = []
        self.outputs: List[GraphBuffer] = []   # set by freeze()
        self.frozen = False
        if lower is None:
            from repro_torch.core.jit import lower_cached

            def lower(source, opts, n_args):
                n = opts.n_inputs if opts.n_inputs is not None else n_args
                return lower_cached(source, n, opts.name)
        self._lower = lower
        self._consumed: Dict[Tuple, bool] = {}   # buffer ref -> ever used
        self._fingerprint: Optional[str] = None  # cached once frozen

    # ------------------------------------------------------------ recording
    def input(self, name: str = "") -> GraphBuffer:
        """Declare an external graph input (bound positionally at launch)."""
        self._check_open()
        buf = GraphBuffer(self, "in", index=len(self.inputs), name=name)
        self.inputs.append(buf)
        return buf

    def call(self, source, opts: Optional[CompileOptions] = None,
             *buffers: GraphBuffer):
        """Record a kernel call; returns its output GraphBuffer (or a tuple
        for multi-output kernels).  Nothing compiles and nothing enqueues —
        the DFG is lowered (µs, frontend-cache backed under a Session) only
        so arity and dataflow validate at record time, not at launch."""
        self._check_open()
        opts = opts if opts is not None else CompileOptions()
        for b in buffers:
            if not isinstance(b, GraphBuffer):
                raise GraphError(
                    f"{self.name}: call arguments must be GraphBuffers "
                    f"(declare external data with g.input()), got "
                    f"{type(b).__name__}")
            if b.graph is not self:
                raise GraphError(
                    f"{self.name}: {b!r} belongs to a different capture")
        g = self._lower(source, opts, len(buffers))
        if len(buffers) != len(g.inputs):
            raise GraphError(
                f"{self.name}: kernel {g.name} takes {len(g.inputs)} "
                f"buffers, got {len(buffers)}")
        node = GraphNode(len(self.nodes), source, g, opts, tuple(buffers))
        self.nodes.append(node)
        for b in buffers:
            self._consumed[b.ref()] = True
        outs = tuple(GraphBuffer(self, "node", nid=node.nid, out_idx=i,
                                 name=f"{g.name}.{i}")
                     for i in range(node.n_outputs))
        return outs[0] if len(outs) == 1 else outs

    def mark_output(self, *buffers: GraphBuffer) -> None:
        """Force ``buffers`` to be graph outputs even if a later call
        consumes them (leaves are outputs automatically)."""
        self._check_open()
        for b in buffers:
            if not isinstance(b, GraphBuffer) or b.graph is not self:
                raise GraphError(f"{self.name}: cannot mark {b!r} as output")
            if b.kind != "node":
                raise GraphError(f"{self.name}: a graph input cannot be a "
                                 f"graph output")
            if b not in self.outputs:
                self.outputs.append(b)

    def _check_open(self) -> None:
        if self.frozen:
            raise GraphError(f"graph {self.name} is frozen (capture ended)")

    # ------------------------------------------------------------- freezing
    def freeze(self) -> "KernelGraph":
        """End of capture: graph outputs become the explicitly marked
        buffers plus every leaf (a node output no later call consumed), in
        production order; the DAG is validated."""
        if not self.frozen:
            marked = {b.ref() for b in self.outputs}
            for node in self.nodes:
                for i in range(node.n_outputs):
                    ref = ("node", node.nid, i)
                    if not self._consumed.get(ref) and ref not in marked:
                        self.outputs.append(
                            GraphBuffer(self, "node", nid=node.nid,
                                        out_idx=i))
            self.frozen = True
            self.validate()
        return self

    def validate(self) -> None:
        """Structural checks: wiring in range, acyclic, outputs exist.

        Capture can only build forward edges, but the graph is plain data —
        re-verify so a mutated or hand-built graph fails here, not deep in
        the fusion pass.  Mutation also invalidates the cached fingerprint:
        a rewired graph that re-validates must not keep hitting Session
        memos (partition plans, nodewise futures) recorded for the old
        dataflow."""
        self._fingerprint = None
        if not self.nodes:
            raise GraphError(f"graph {self.name} records no calls")
        by_nid = {n.nid: n for n in self.nodes}   # positions may be mutated
        for node in self.nodes:
            for b in node.args:
                ref = b.ref()
                if ref[0] == "in":
                    if not 0 <= ref[1] < len(self.inputs):
                        raise GraphError(f"{self.name}: N{node.nid} reads "
                                         f"undeclared input {ref[1]}")
                else:
                    src = by_nid.get(ref[1])
                    if src is None:
                        raise GraphError(f"{self.name}: N{node.nid} reads "
                                         f"unknown node {ref[1]}")
                    if not 0 <= ref[2] < src.n_outputs:
                        raise GraphError(
                            f"{self.name}: N{node.nid} reads output "
                            f"{ref[2]} of N{src.nid} "
                            f"({src.n_outputs} outputs)")
        for b in self.outputs:
            if b.kind != "node" or b.nid not in by_nid:
                raise GraphError(f"{self.name}: dangling graph output {b!r}")
        self.toposort()   # raises GraphError on a cycle

    def node_deps(self, node: GraphNode) -> List[int]:
        """nids of the nodes whose outputs ``node`` consumes."""
        return sorted({b.nid for b in node.args if b.kind == "node"})

    def toposort(self) -> List[GraphNode]:
        order: List[GraphNode] = []
        done: set = set()
        pending = list(self.nodes)
        while pending:
            ready, rest = [], []
            for n in pending:
                (ready if all(d in done for d in self.node_deps(n))
                 else rest).append(n)
            if not ready:
                raise GraphError(f"cycle in graph {self.name}")
            order.extend(ready)
            done.update(n.nid for n in ready)
            pending = rest
        return order

    # ---------------------------------------------------------- fingerprint
    def fingerprint(self) -> str:
        """Content hash of the whole recorded graph: node DFG fingerprints,
        their artifact-relevant options, the wiring and the output list.
        Two captures recording the same pipeline hash identically, so the
        Session can memoize its partition plan across instantiations.
        Cached once frozen — replay paths key on it per request."""
        if self.frozen and self._fingerprint is not None:
            return self._fingerprint
        parts = []
        for node in self.nodes:
            wiring = ",".join(str(b.ref()) for b in node.args)
            cap = node.opts.max_replicas
            parts.append(f"{dfg_fingerprint(node.dfg)}"
                         f"[{node.opts.key_tail()};r{cap}]({wiring})")
        sig = "|".join(parts) + ">" + ",".join(str(b.ref())
                                               for b in self.outputs)
        fp = hashlib.sha256(sig.encode()).hexdigest()
        if self.frozen:
            self._fingerprint = fp
        return fp

    # -------------------------------------------------------------- context
    def __enter__(self) -> "KernelGraph":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        if exc_type is None:
            self.freeze()

    def __repr__(self) -> str:
        return (f"KernelGraph({self.name}: {len(self.nodes)} nodes, "
                f"{len(self.inputs)} inputs, "
                f"{len(self.outputs)} outputs"
                f"{', frozen' if self.frozen else ''})")


# ================================================================ partitions

@dataclasses.dataclass
class Partition:
    """One overlay configuration of an instantiated graph: a set of
    dependency-closed nodes fused into a single DFG."""
    index: int
    node_ids: List[int]
    dfg: DFG                              # the fused kernel
    opts: CompileOptions                  # merged build options
    ext: List[Tuple]                      # fused-input order: buffer refs
    outputs: List[Tuple[int, int]]        # exposed (nid, out_idx), in order
    deps: List[int] = dataclasses.field(default_factory=list)

    def out_pos(self, nid: int, out_idx: int) -> int:
        """Position of a node output among the fused kernel's outputs."""
        return self.outputs.index((nid, out_idx))

    def ext_index(self) -> Dict[Tuple, int]:
        """Buffer ref -> position among the fused kernel's external inputs.
        The nodewise degradation ladder uses this to map a failed fused
        partition's argument buffers back onto per-node wiring."""
        return {tuple(ref): i for i, ref in enumerate(self.ext)}


def _graph_consumers(graph: KernelGraph) -> Dict[Tuple[int, int], List[int]]:
    """(nid, out_idx) -> consuming nids, computed once per partitioning."""
    consumers: Dict[Tuple[int, int], List[int]] = {}
    for node in graph.nodes:
        for b in node.args:
            if b.kind == "node":
                consumers.setdefault((b.nid, b.out_idx), []).append(node.nid)
    return consumers


def _fuse_partition(graph: KernelGraph, nodes: Sequence[GraphNode],
                    index: int, run_optimize: bool = True,
                    consumers: Optional[Dict] = None) -> Partition:
    """Fuse ``nodes`` (a topologically contiguous group) into one Partition.

    External inputs are graph inputs and outputs of nodes OUTSIDE the group;
    a node output is kept (exposed) iff something outside the group — a
    later node or the graph's caller — observes it.  Everything else is an
    elided intermediate."""
    local = {n.nid: i for i, n in enumerate(nodes)}
    if consumers is None:
        consumers = _graph_consumers(graph)
    graph_outs = {b.ref()[1:] for b in graph.outputs}

    parts = []
    for n in nodes:
        refs = []
        for b in n.args:
            if b.kind == "node" and b.nid in local:
                refs.append(("int", local[b.nid], b.out_idx))
            else:
                refs.append(("ext", b.ref()))
        parts.append((n.dfg, refs))

    keep: List[Tuple[int, int]] = []
    out_map: List[Tuple[int, int]] = []
    for n in nodes:
        for oi in range(n.n_outputs):
            used_outside = any(c not in local
                               for c in consumers.get((n.nid, oi), ()))
            if used_outside or (n.nid, oi) in graph_outs:
                keep.append((local[n.nid], oi))
                out_map.append((n.nid, oi))

    pname = "+".join(n.dfg.name for n in nodes)
    if len(pname) > 48:
        pname = f"{pname[:45]}+{len(nodes)}k"
    fused, ext_keys = fuse_dfgs(parts, keep, name=pname,
                                run_optimize=run_optimize)

    caps = [n.opts.max_replicas for n in nodes
            if n.opts.max_replicas is not None]
    # max_partition_fus did its job choosing the cut; keeping it on the
    # fused opts would split the Session's single-flight key between
    # graphs recorded with different caps that fused to the same kernel
    opts = nodes[0].opts.replace(
        n_inputs=len(fused.inputs), name=pname,
        max_replicas=min(caps) if caps else None,
        max_partition_fus=None)
    return Partition(index, [n.nid for n in nodes], fused, opts,
                     [k for k in ext_keys], out_map)


def partition_graph(graph: KernelGraph, spec: OverlaySpec,
                    max_partition_fus: Optional[int] = None
                    ) -> List[Partition]:
    """Cut a frozen graph into fused partitions under resource constraints.

    Greedy in topological order: each node joins the open partition when
    (a) its build options are :meth:`~CompileOptions.fuse_compatible` with
    the partition's, and (b) the *fused* kernel still fits the device with
    at least one replica — FU count within ``max_partition_fus`` (default:
    the spec's whole FU array) and external IO within the perimeter pad
    budget.  Because nodes are visited topologically and only the LAST
    partition is open, every cross-partition edge points backward — the
    partition DAG is acyclic by construction, so replay can express
    cross-partition dependencies as plain event edges.

    Replica budget is not decided here: each partition's compile runs the
    ordinary :func:`~repro_torch.core.replicate.plan_replication` against the
    fleet's live ledger, so resident partitions split the fabric exactly
    like any other co-resident programs.
    """
    if not graph.frozen:
        raise GraphError(f"graph {graph.name} must be frozen before "
                         f"partitioning (end the capture block)")
    fu_budget = spec.n_fus if max_partition_fus is None \
        else min(max_partition_fus, spec.n_fus)
    consumers = _graph_consumers(graph)

    def fits(nodes: Sequence[GraphNode]) -> Optional[Partition]:
        # each probe re-fuses the open group (quadratic in group size, but
        # group size is bounded by the device's FU capacity); the
        # whole-graph consumer map is hoisted out of the loop.  Probing the
        # OPTIMIZED fused DFG credits cross-kernel CSE, so a pair whose
        # shared subexpression brings it under budget packs into one
        # config instead of paying a split
        try:
            part = _fuse_partition(graph, nodes, index=0,
                                   consumers=consumers)
        except FusionError:
            return None
        fug = to_fu_graph(part.dfg, dsp_per_fu=spec.dsp_per_fu)
        if fug.n_fus > fu_budget or fug.n_io > spec.n_io:
            return None
        if plan_replication(fug, spec).replicas < 1:
            return None
        return part

    # the accepted probe IS the final fusion (a closed group's external
    # inputs/outputs depend only on its own membership and the fixed
    # consumer map), so it is kept instead of re-fused at the end
    groups: List[List[GraphNode]] = []
    partitions: List[Partition] = []
    for node in graph.toposort():
        if groups and groups[-1][0].opts.fuse_compatible(node.opts):
            trial = fits(groups[-1] + [node])
            if trial is not None:
                groups[-1].append(node)
                partitions[-1] = trial
                continue
        single = fits([node])
        if single is None:
            raise GraphError(
                f"{graph.name}: node N{node.nid} ({node.dfg.name}) "
                f"does not fit the overlay even alone "
                f"({spec.n_fus} FUs / {spec.n_io} IO)")
        groups.append([node])
        partitions.append(single)

    owner: Dict[int, int] = {}
    for idx, part in enumerate(partitions):
        part.index = idx
        for nid in part.node_ids:
            owner[nid] = idx
        part.deps = sorted({owner[ref[1]] for ref in part.ext
                            if ref[0] == "node"})
    return partitions


def partition_graph_grouped(graph: KernelGraph, spec: OverlaySpec,
                            groups: Sequence[Sequence[int]],
                            max_partition_fus: Optional[int] = None
                            ) -> List[Partition]:
    """Cut a frozen graph along an *explicit* grouping of node ids.

    ``groups`` must list every node id exactly once, as consecutive
    intervals of the graph's topological order — the same interval shape
    the greedy cut produces, which keeps the partition DAG acyclic (every
    cross-group edge points backward).  Each group is validated against
    the identical feasibility checks :func:`partition_graph` applies
    (fuse compatibility, FU/IO budget, at least one replica), so a
    caller-chosen cut — e.g. the profile-guided re-cutter — can never
    produce a partition the greedy cut would have refused.
    """
    if not graph.frozen:
        raise GraphError(f"graph {graph.name} must be frozen before "
                         f"partitioning (end the capture block)")
    order = [n.nid for n in graph.toposort()]
    flat = [nid for grp in groups for nid in grp]
    if flat != order:
        raise GraphError(
            f"{graph.name}: groups must cover the topological order as "
            f"consecutive intervals (got {flat}, want {order})")
    fu_budget = spec.n_fus if max_partition_fus is None \
        else min(max_partition_fus, spec.n_fus)
    consumers = _graph_consumers(graph)
    by_nid = {n.nid: n for n in graph.nodes}

    partitions: List[Partition] = []
    for gi, grp in enumerate(groups):
        nodes = [by_nid[nid] for nid in grp]
        head = nodes[0]
        for n in nodes[1:]:
            if not head.opts.fuse_compatible(n.opts):
                raise GraphError(
                    f"{graph.name}: group {gi} mixes fuse-incompatible "
                    f"options (N{head.nid} vs N{n.nid})")
        try:
            part = _fuse_partition(graph, nodes, index=gi,
                                   consumers=consumers)
        except FusionError as e:
            raise GraphError(f"{graph.name}: group {gi} does not "
                             f"fuse: {e}") from e
        fug = to_fu_graph(part.dfg, dsp_per_fu=spec.dsp_per_fu)
        if fug.n_fus > fu_budget or fug.n_io > spec.n_io:
            raise GraphError(
                f"{graph.name}: group {gi} ({part.dfg.name}) needs "
                f"{fug.n_fus} FUs / {fug.n_io} IO, budget is "
                f"{fu_budget} FUs / {spec.n_io} IO")
        if plan_replication(fug, spec).replicas < 1:
            raise GraphError(
                f"{graph.name}: group {gi} ({part.dfg.name}) admits "
                f"no replica on {spec.width}x{spec.height}")
        partitions.append(part)

    owner: Dict[int, int] = {}
    for idx, part in enumerate(partitions):
        for nid in part.node_ids:
            owner[nid] = idx
        part.deps = sorted({owner[ref[1]] for ref in part.ext
                            if ref[0] == "node"})
    return partitions
