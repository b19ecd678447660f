"""The JIT entry point: end-to-end run-time compilation to the overlay.

``jit_compile`` chains every stage of the paper's Fig. 2 flow —
frontend → optimize → FU-aware fuse → resource-aware replicate → place →
route → latency-balance → bitstream + linear program — and returns a
``CompiledKernel`` with per-stage wall times (the PAR-time benchmarks read
these) and three execution paths:

  * ``__call__``       — "compiled mode": the routed DFG evaluated as torch
                         ops on the caller's tensors; embeds in larger torch
                         computations.
  * ``run_overlay``    — the config-driven CUDA overlay executor (one thread
                         per work-item interpreting the program); the program
                         is data, so swapping kernels does NOT rebuild the
                         executor (the 42 µs-reconfig analogue).
  * ``run_reference``  — pure-numpy oracle.

``__call__`` and ``run_overlay`` run on the CUDA card unless the caller
passes ``device="cpu"`` or CPU tensors (:mod:`repro_torch.device`); they
return tensors on the device they ran on.

Two P&R strategies feed the place/route/latency stages (``pr_mode``):

  * ``"template"`` — place & route ONE replica in a compact region, stamp
    R transformed copies on all four perimeter edges, and grow toward the
    replication plan with per-replica gap fill (:mod:`repro_torch.core.template`).
    P&R cost is O(one replica) + O(one replica per remnant); with a
    :class:`~repro_torch.core.cache.JITCache` the template itself is cached on
    (kernel, spec, seed, effort) — independent of the free-resource
    snapshot — so replica-count changes skip place/route entirely and only
    re-stamp (``stage_times_ms["stamp"]``).
  * ``"joint"``    — the original annealer over all R replicas at once;
    kept for parity testing and as the last-resort fallback.
  * ``"auto"``     — the default: the template path, unless it cannot reach
    ``min_template_fill`` of the planned replica count, in which case the
    joint annealer runs and the better of the two artifacts (by achieved
    replicas; template wins ties — it is orders of magnitude cheaper to
    rebuild) is returned.  Resource-aware replication is therefore never
    degraded below what the joint path would have delivered, and on fills
    the template path can reach (≥ 95 % of plan by default — in practice
    all of the bench suite) the joint annealer never runs at all.

With a cache the full build is keyed on a content hash of (kernel, spec,
effective replication cap, knobs) — see :func:`repro_torch.core.cache.make_cache_key`
for why the free-resource snapshot is *normalized* to the replica cap it
implies before hashing.  A :class:`~repro_torch.core.cache.JITCache` constructed
with ``persist_dir`` additionally writes every artifact through to a
content-addressed on-disk store, so a restarted process warm-loads compiled
kernels in milliseconds instead of recompiling.

``CompileOptions.verify_level`` gates a build through the static verifier
(:mod:`repro_torch.analysis`): "fused" checks the DFG's semantics before any
mapping stage, "full" also re-proves every artifact it hands out, a cache
hit included.  Verification is host work over the artifact, which holds no
tensor.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from repro_torch.core import template as template_mod
from repro_torch.core.bitstream import Bitstream, generate
from repro_torch.core.cache import JITCache, make_cache_key, make_template_key
from repro_torch.core.dfg import DFG, optimize, trace
from repro_torch.core.faults import InjectedFault, fault_point
from repro_torch.core.fuse import FUGraph, to_fu_graph
from repro_torch.core.ir import compile_opencl_to_dfg, _lower_consts
from repro_torch.core.latency import LatencyAssignment, balance
from repro_torch.core.options import CompileOptions, DEFAULT_MIN_TEMPLATE_FILL
from repro_torch.core.overlay import OverlaySpec
from repro_torch.core.place import Placement, place
from repro_torch.core.program import OverlayProgram, compile_program
from repro_torch.core.replicate import ReplicationPlan, plan_replication, \
    throughput_gops
from repro_torch.core.route import RoutingResult, route
from repro_torch.device import DeviceLike, to_tensors
from repro_torch.obs import trace as obs_trace

__all__ = ["CompiledKernel", "CompileOptions", "DEFAULT_MIN_TEMPLATE_FILL",
           "jit_compile", "lower_cached", "lower_to_dfg", "overlay_jit"]


@dataclasses.dataclass
class CompiledKernel:
    name: str
    dfg: DFG
    fug: FUGraph
    spec: OverlaySpec
    plan: ReplicationPlan
    placement: Placement
    routing: RoutingResult
    latency: LatencyAssignment
    bitstream: Bitstream
    program: OverlayProgram
    stage_times_ms: Dict[str, float]
    pr_path: str = "joint"        # which P&R strategy produced the artifact

    # ------------------------------------------------------------- numbers
    @property
    def par_time_ms(self) -> float:
        return (self.stage_times_ms["place"] + self.stage_times_ms["route"] +
                self.stage_times_ms.get("stamp", 0.0) +
                self.stage_times_ms.get("infill", 0.0))

    @property
    def compile_time_ms(self) -> float:
        return sum(self.stage_times_ms.values())

    @property
    def pipeline_depth(self) -> int:
        return self.latency.pipeline_depth

    def throughput_gops(self) -> float:
        return throughput_gops(self.fug, self.spec, self.plan.replicas)

    def resources(self) -> Dict[str, int]:
        return dict(
            fus=self.plan.fus_used,
            dsp=self.plan.fus_used * self.spec.dsp_per_fu,
            io=self.plan.io_used,
            wires=self.routing.wires_used(),
            config_bytes=self.bitstream.n_bytes,
        )

    # ------------------------------------------------------------ execution
    def __call__(self, *inputs, device: DeviceLike = None):
        """Compiled mode: evaluate the routed DFG as torch ops.  Tensors
        keep their dtype and device; numpy arrays and scalars become
        float32 tensors on ``device`` (default: the CUDA card).
        Semantically identical to the configured overlay."""
        return _unpack(self.dfg.evaluate(
            to_tensors(inputs, device, dtype=None)))

    def run_reference(self, *inputs):
        arrs = [np.asarray(x, np.float32) for x in inputs]
        return _unpack(self.dfg.evaluate(arrs))

    def run_overlay(self, *inputs, device: DeviceLike = None):
        """Execute through the overlay executor: the CUDA kernel for CUDA
        tensors (numpy inputs go to ``device``, default the card), its
        plain PyTorch version for CPU tensors.  Returns float32 tensors."""
        from repro_torch.kernels.overlay_exec import ops
        return _unpack(ops.execute(self.program, list(inputs),
                                   device=device))


def _unpack(outs: List[Any]):
    return outs[0] if len(outs) == 1 else tuple(outs)


def lower_to_dfg(kernel: Union[str, Callable, DFG],
                 n_inputs: Optional[int] = None,
                 name: Optional[str] = None,
                 parse_source: bool = False) -> Union[str, DFG]:
    """Lower a callable (and, with ``parse_source``, OpenCL-C text) to a DFG
    so repeated compile probes / cache keying don't re-trace or re-parse.
    DFGs pass through; str passes through unless ``parse_source``.

    Every returned DFG is fully optimized (``DFG.optimized`` set), so the
    frontend stage of a subsequent ``jit_compile`` is a no-op and every
    entry point keys the same kernel by the same normal form — a cache miss
    pays the frontend exactly once whichever path lowered the kernel."""
    if isinstance(kernel, DFG):
        return kernel if kernel.optimized else \
            optimize(_lower_consts(kernel))
    if isinstance(kernel, str):
        return compile_opencl_to_dfg(kernel) if parse_source else kernel
    if n_inputs is None:
        raise ValueError("n_inputs required when tracing a python kernel")
    return optimize(_lower_consts(trace(kernel, n_inputs, name)))


def lower_cached(kernel: Union[str, Callable, DFG],
                 n_inputs: Optional[int] = None,
                 name: Optional[str] = None,
                 cache: Optional["JITCache"] = None) -> DFG:
    """:func:`lower_to_dfg` through a cache's frontend tier.

    OpenCL text keys on the raw source hash (computable without parsing),
    so a warm process skips even parse+optimize.  This is THE lowering
    entry point shared by ``jit_compile``, graph capture and the default
    :class:`~repro_torch.core.graph.KernelGraph` lowerer — one definition of the
    cached normal form."""
    if cache is not None and isinstance(kernel, str):
        from repro_torch.core.cache import kernel_fingerprint
        fkey = kernel_fingerprint(kernel)
        g = cache.get_frontend(fkey)
        if g is None:
            g = lower_to_dfg(kernel, n_inputs, name, parse_source=True)
            cache.put_frontend(fkey, g)
        return g
    return lower_to_dfg(kernel, n_inputs, name, parse_source=True)


def jit_compile(kernel: Union[str, Callable, DFG],
                spec: OverlaySpec,
                n_inputs: Optional[int] = None,
                name: Optional[str] = None,
                max_replicas: Optional[int] = None,
                fu_headroom: int = 0,
                io_headroom: int = 0,
                seed: int = 0,
                place_effort: float = 1.0,
                cache: Optional["JITCache"] = None,
                pr_mode: str = "auto",
                min_template_fill: float = DEFAULT_MIN_TEMPLATE_FILL,
                opts: Optional[CompileOptions] = None) -> CompiledKernel:
    """Full JIT pipeline. Raises PlacementError/RoutingError/LatencyError on
    genuine mapping failures (kernel too big for the exposed overlay).

    The canonical way to tune the build is one frozen
    :class:`~repro_torch.core.options.CompileOptions` value (``opts``) — the same
    object the Session API and the cache key consume.  The loose keyword
    knobs are the **deprecated** legacy shim: when ``opts`` is None they
    are folded into one (and validated there) under a DeprecationWarning
    if any build knob is actually set; when ``opts`` is given they are
    ignored.  (``n_inputs``/``name`` alone stay silent — they describe the
    kernel, not the build, and remain the convenient way to trace a python
    callable.)

    With ``cache``, the build is keyed on a content hash of (kernel, spec,
    effective replica cap implied by the free-resource snapshot,
    ``opts.key_tail()``); a hit returns the previously built CompiledKernel
    without running any compiler stage (under ``verify_level="full"`` the
    hit is re-proved first, and quarantined and rebuilt if the re-proof
    fails).  ``opts.pr_mode`` selects the P&R
    strategy (see module docstring): ``"auto"`` (default), ``"template"``,
    or ``"joint"``; ``opts.min_template_fill`` is the fraction of the
    planned replica count the template path must reach for ``auto`` to skip
    the joint annealer.
    """
    if opts is None:
        if (max_replicas is not None or seed != 0 or place_effort != 1.0
                or pr_mode != "auto"
                or min_template_fill != DEFAULT_MIN_TEMPLATE_FILL):
            import warnings
            warnings.warn(
                "jit_compile with raw build knobs (max_replicas/seed/"
                "place_effort/pr_mode/min_template_fill) is deprecated; "
                "pass opts=CompileOptions(...) — see the ROADMAP "
                "'Runtime v2' migration table",
                DeprecationWarning, stacklevel=2)
        # CompileOptions.__post_init__ validates pr_mode / fill range
        opts = CompileOptions(n_inputs=n_inputs, name=name,
                              max_replicas=max_replicas, seed=seed,
                              place_effort=place_effort, pr_mode=pr_mode,
                              min_template_fill=min_template_fill)
    n_inputs, name = opts.n_inputs, opts.name
    times: Dict[str, float] = {}

    # frontend runs before the cache lookup: keying needs the DFG normal
    # form, and snapshot normalization needs the FU graph — both are
    # microseconds next to any P&R stage, so the warm path stays ~free.
    # OpenCL text goes through the cache's frontend tier (keyed on the raw
    # source hash, computable without parsing), so a warm process skips
    # even the parse+optimize pipeline
    t0 = time.perf_counter()
    with obs_trace.span("jit:frontend", "compile") as _sp:
        g = lower_cached(kernel, n_inputs, name, cache=cache)
        fault_point("frontend", g.name)
        _sp["kernel"] = g.name
    times["frontend"] = (time.perf_counter() - t0) * 1e3

    if opts.verify_level != "off":
        # semantic gate BEFORE any mapping stage: a malformed DFG (undefined
        # producer, broken IO perimeter, cycle) fails here with structured
        # diagnostics instead of an obscure KeyError deep inside clustering
        # or placement.  VerificationError propagates like any mapping error.
        from repro_torch.analysis.dfg_checks import assert_clean
        t0 = time.perf_counter()
        try:
            with obs_trace.span("jit:verify", "compile", kernel=g.name):
                assert_clean(g, origin="jit")
        finally:
            times["verify"] = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    with obs_trace.span("jit:fuse", "compile", kernel=g.name):
        fug = to_fu_graph(g, dsp_per_fu=spec.dsp_per_fu)
    times["fuse"] = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    with obs_trace.span("jit:replicate", "compile", kernel=g.name):
        plan = plan_replication(fug, spec, max_replicas=opts.max_replicas,
                                fu_headroom=fu_headroom,
                                io_headroom=io_headroom)
    if plan.replicas == 0:
        from repro_torch.core.place import PlacementError
        raise PlacementError(
            f"kernel needs {fug.n_fus} FUs / {fug.n_io} IO; overlay exposes "
            f"{spec.n_fus - fu_headroom} FUs / {spec.n_io - io_headroom} IO")
    times["replicate"] = (time.perf_counter() - t0) * 1e3

    key = None
    if cache is not None:
        key = make_cache_key(g, spec,
                             free_fus=spec.n_fus - fu_headroom,
                             free_io=spec.n_io - io_headroom,
                             opts=opts, fug=fug)
        with obs_trace.span("jit:cache", "compile", kernel=g.name) as _sp:
            hit = cache.get(key)
            _sp["hit"] = hit is not None
        if hit is not None:
            if opts.verify_level != "full":
                return hit
            # "full" re-proves every artifact it is about to hand out; a
            # hit that fails the re-proof is quarantined exactly like a
            # corrupt DiskCache pickle and the build falls through to a
            # fresh compile below
            from repro_torch.analysis.artifact import verify_artifact
            from repro_torch.analysis.diagnostics import ERROR as _A_ERROR
            t0 = time.perf_counter()
            bad = [d for d in verify_artifact(hit)
                   if d.severity == _A_ERROR]
            times["verify"] = (time.perf_counter() - t0) * 1e3
            if not bad:
                return hit
            cache.quarantine(key)

    # ---- template path: P&R one replica, stamp R copies, gap-fill ---------
    tpl_out = None
    ttimes: Dict[str, float] = {}
    if opts.pr_mode in ("auto", "template"):
        try:
            tpl_out = _template_par(fug, g, spec, plan, opts.seed,
                                    opts.place_effort, cache, opts.pr_mode,
                                    ttimes)
        except InjectedFault:
            # degradation ladder, rung 1: an injected fault anywhere in the
            # template path (single-replica place, strip route, stamp) is
            # absorbed by falling back to the joint annealer — forced
            # "template" mode propagates so the Session retry loop owns it
            if opts.pr_mode == "template":
                raise
            from repro_torch.core import recovery
            recovery.note("fallback_joint")
            tpl_out = None

    use_template = False
    if tpl_out is not None:
        achieved = tpl_out[3].replicas
        need = plan.replicas if opts.pr_mode == "template" else \
            math.ceil(opts.min_template_fill * plan.replicas)
        use_template = opts.pr_mode == "template" or achieved >= need

    if not use_template:
        # ---- joint path: anneal all replicas, congestion back-off ---------
        from repro_torch.core.latency import LatencyError
        from repro_torch.core.route import RoutingError

        last_err: Optional[Exception] = None
        t_place = t_route = t_lat = 0.0
        placement = routing = lat = None
        replicas = plan.replicas
        while replicas >= 1:
            try:
                t0 = time.perf_counter()
                with obs_trace.span("jit:place", "compile", kernel=g.name,
                                    replicas=replicas):
                    placement = place(fug, spec, replicas=replicas,
                                      seed=opts.seed,
                                      effort=opts.place_effort)
                t_place = (time.perf_counter() - t0) * 1e3
                t0 = time.perf_counter()
                with obs_trace.span("jit:route", "compile", kernel=g.name):
                    routing = route(fug, spec, placement, replicas=replicas)
                t_route = (time.perf_counter() - t0) * 1e3
                t0 = time.perf_counter()
                with obs_trace.span("jit:latency", "compile",
                                    kernel=g.name):
                    lat = balance(fug, spec, routing)
                t_lat = (time.perf_counter() - t0) * 1e3
                break
            except (RoutingError, LatencyError) as e:
                last_err = e
                replicas -= max(1, replicas // 8)
        if placement is None or routing is None or lat is None:
            if tpl_out is None:
                raise last_err  # even a single copy does not map
            replicas = 0       # template artifact is all we have
        if tpl_out is not None and tpl_out[3].replicas >= replicas:
            # the joint annealer backed off to (or below) what the template
            # path already achieved: keep the template artifact — same or
            # better fill, and orders of magnitude cheaper to rebuild
            use_template = True
            times["joint_probe"] = t_place + t_route + t_lat
        else:
            if replicas != plan.replicas:
                plan = plan.with_replicas(fug, replicas, "congestion")
            times["place"] = t_place
            times["route"] = t_route
            times["latency"] = t_lat
            if ttimes:
                # the spent template probe stays on the books so
                # compile_time_ms reports real wall time
                times["template_probe"] = sum(ttimes.values())

    pr_path = "joint"
    if use_template:
        placement, routing, lat, plan = tpl_out
        times.update(ttimes)
        pr_path = "template"

    t0 = time.perf_counter()
    with obs_trace.span("jit:bitstream", "compile", kernel=g.name):
        bs = generate(fug, spec, placement, routing, lat, plan.replicas)
        prog = compile_program(fug.dfg)
    times["bitstream"] = (time.perf_counter() - t0) * 1e3

    ck = CompiledKernel(g.name, fug.dfg, fug, spec, plan, placement,
                        routing, lat, bs, prog, times, pr_path=pr_path)
    if opts.verify_level == "full":
        # the artifact re-proof runs BEFORE cache.put: an artifact that
        # fails its own legality re-proof must never become someone else's
        # cache hit.  VerificationError propagates to the caller like any
        # other mapping failure.
        from repro_torch.analysis.artifact import assert_valid
        t0 = time.perf_counter()
        try:
            assert_valid(ck)
        finally:
            times["verify"] = times.get("verify", 0.0) + \
                (time.perf_counter() - t0) * 1e3
    if cache is not None and key is not None:
        cache.put(key, ck)
    return ck


def _template_par(fug: FUGraph, g: DFG, spec: OverlaySpec,
                  plan: ReplicationPlan, seed: int, place_effort: float,
                  cache: Optional["JITCache"], pr_mode: str,
                  times: Dict[str, float]):
    """Run the template-stamping P&R path: fetch/build the template, stamp
    up to its slot capacity, then gap-fill toward the replication plan.

    Returns (placement, routing, latency, plan) — with ``plan`` re-targeted
    at the achieved replica count when the template path fell short — or
    None when no template region maps at all (``auto`` then falls back to
    the joint annealer; forced ``template`` mode re-raises).  Stage times
    land in ``times``: a template cache hit books zero place/route/latency
    (the stages did not run), and gap-fill time is booked under "infill".
    """
    tkey = make_template_key(g, spec, seed, place_effort) \
        if cache is not None else None
    tmpl = cache.get_template(tkey) if cache is not None else None
    built = False
    if tmpl is None:
        try:
            with obs_trace.span("jit:template_build", "compile",
                                kernel=g.name):
                tmpl = template_mod.build_template(fug, spec, seed=seed,
                                                   effort=place_effort,
                                                   target=plan.replicas)
        except template_mod.TemplateError:
            if pr_mode == "template":
                raise
            return None
        built = True
        if cache is not None:
            cache.put_template(tkey, tmpl)

    # plan.replicas >= 1 was enforced by the caller and a built Template
    # always has at least one verified slot, so replicas >= 1 here
    replicas = min(plan.replicas, tmpl.capacity)

    # a template hit means the place/route/latency stages did not run at all
    times["place"] = tmpl.build_ms["place"] if built else 0.0
    times["route"] = tmpl.build_ms["route"] if built else 0.0
    times["latency"] = tmpl.build_ms["latency"] if built else 0.0
    if built and tmpl.build_ms.get("scan", 0.0) > 0.0:
        times["template_scan"] = tmpl.build_ms["scan"]
    t0 = time.perf_counter()
    with obs_trace.span("jit:stamp", "compile", kernel=g.name,
                        replicas=replicas):
        fault_point("stamp", g.name)
        placement, routing, lat = template_mod.stamp(tmpl, spec, replicas)
    times["stamp"] = (time.perf_counter() - t0) * 1e3
    if replicas < plan.replicas:
        t0 = time.perf_counter()
        with obs_trace.span("jit:infill", "compile", kernel=g.name):
            placement, routing, lat, replicas = template_mod.gap_fill(
                fug, spec, placement, routing, lat, plan.replicas,
                seed=seed, effort=place_effort)
        times["infill"] = (time.perf_counter() - t0) * 1e3
    if replicas != plan.replicas:
        plan = plan.with_replicas(fug, replicas, "stamp")
    return placement, routing, lat, plan


def overlay_jit(fn: Callable, n_inputs: int, spec: Optional[OverlaySpec] = None,
                **kw) -> CompiledKernel:
    """Decorator-style helper for model code: declare a pointwise
    datapath as an overlay kernel.

    >>> swish_poly = overlay_jit(lambda x: x * (x * (x * 0.044715 + 1.0)), 1)
    """
    spec = spec or OverlaySpec()
    return jit_compile(fn, spec, n_inputs=n_inputs, **kw)
