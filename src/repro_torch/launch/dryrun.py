"""Production dry run: does every (arch × shape × mesh) step run on the
production mesh, and what do its compute, memory and collective terms say?

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \
      --shape train_4k [--multi-pod] [--remat dots] [--out results.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

The JAX package lowers each cell on 512 XLA:CPU placeholders and reads the
compiled per-device HLO.  Torch has no HLO, so this module runs the port's
own step (``make_train_step``, ``make_prefill_step`` or
``make_serve_step``) once on rank 0 of a fake world: a ``"fake"`` process
group of 256 ranks (512 with ``--multi-pod``) in this one process, whose
collectives return at once, the production mesh over it, and every
parameter, optimizer leaf, cache and input a fake tensor
(``FakeTensorMode``: shapes, dtypes and placements, no storage) placed by
its sharding spec.  A context-parallel prefill (``--seq-shard-prefill``)
is traced on rank 15 instead, the last block of the sequence on 'model'
(``LAST_BLOCK_RANK``): the ranks' work differs there, and that block's
queries attend every key.  The per-rank program is counted as it runs:

- FLOPs by ``FlopCounterMode``;
- bytes: each op's inputs and outputs (views, allocations and
  collectives move none here), eager's unfused traffic;
- collectives by kind with their local payload (DTensor's functional
  collectives and the c10d ones: the port's gathers are c10d's), their
  number held against ``CommDebugMode``'s count of calls;
- peak memory (arguments plus temporaries) by ``MemTracker``.

All of it is host work, as the JAX package's dry run is: no card is
needed and no kernel is launched.  The fake tensors live on the CPU
device, so each kernel wrapper takes its plain route (the JAX package's
default is ``attn_impl="ref"`` too); this is the dry run's design, not a
fallback from the card.  A fake CUDA tensor is never made: it would hand
the ctypes-bound kernels tensors without storage.  The attention counted
is therefore the plain one, which materialises the scores: its FLOPs are
the full square (causal masks nothing away) and its bytes and memory hold
S.

The counts are the rank's own: an op on DTensors is left to DTensor
(the counting mode returns ``NotImplemented``, as ``CommDebugMode``
does), which splits it into the local ops that are counted; the ops
DTensor runs on global shapes to infer an output's metadata
(``torch/distributed/tensor/_sharding_prop.py``) are not counted.  Eager
has no scan: every layer is counted once per trip, so the JAX package's
``correct_scan_costs`` (solving a layer's cost from two shallow compiles)
is already satisfied here; the argument is kept and changes nothing.

Each cell's result has the JAX package's keys, so its report reads this
artifact.  Two keys mean what torch has: ``lower_s`` is the host seconds
of the traced step (its state built and placed included) and
``compile_s`` is 0.0, since eager compiles nothing.  ``bytes_per_device``
is ``MemTracker``'s peak, ``output_bytes`` the step's results on the
rank.

A cell that raises is an error row, and ``--all`` then exits 1, as the
JAX package's does.  Importing this module starts no process group: the world
starts in :func:`main` and :func:`dryrun_cell` (:func:`fake_world`), and
neither runs beside a group that is not fake.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_flatten

from repro_torch.configs.registry import (ALL_ARCHS, SHAPES, get_arch,
                                          shape_applicable)
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import (check_widths, make_production_mesh,
                                     place, placements)
from repro_torch.models.common import P
from repro_torch.models.registry import (build_model, input_shardings,
                                         input_specs)
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import (init_state, make_prefill_step,
                                    make_serve_step, make_train_step,
                                    state_specs)

# the ops DTensor runs on global shapes, only to infer an output's
# metadata, come from this file of torch
_SHARDING_PROP = os.path.join("distributed", "tensor", "_sharding_prop.py")

# collective kinds by the words of their op names (c10d's and the
# functional collectives'), in the HLO's names
_KINDS = (("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
          ("all_gather", "all-gather"), ("allgather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"),
          ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
          ("send", "collective-permute"), ("recv", "collective-permute"),
          ("broadcast", "broadcast"))
_COLLECTIVE_NAMESPACES = frozenset({"c10d", "_c10d_functional",
                                    "c10d_functional",
                                    "_c10d_functional_autograd"})

aten = torch.ops.aten
# ops that move no bytes: allocations, and results that alias an input
_FREE = frozenset({aten.empty.memory_format, aten.empty_strided.default,
                   aten.new_empty.default, aten.new_empty_strided.default,
                   aten.empty_like.default, aten._unsafe_view.default,
                   aten.lift_fresh.default})
# in-place ops that write their first argument without reading it
_WRITE_ONLY = frozenset({aten.copy_.default, aten.fill_.Scalar,
                         aten.zero_.default})


def _in_sharding_prop() -> bool:
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith(_SHARDING_PROP):
            return True
        f = f.f_back
    return False


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _collective_kind(func) -> Optional[str]:
    if func.namespace not in _COLLECTIVE_NAMESPACES:
        return None
    name = func._schema.name.split("::")[-1]
    return next((kind for word, kind in _KINDS if word in name), None)


class _RankCounter(TorchDispatchMode):
    """The top of the dry run's mode stack: leaves ops on DTensors to
    DTensor, runs the metadata ops of DTensor's sharding propagation with
    every counting mode off, and counts the bytes and collectives of the
    rank's local ops (the modes below count FLOPs, calls and memory)."""

    def __init__(self, fake_mode):
        super().__init__()
        self.fake_mode = fake_mode
        self.bytes = 0
        self.collectives: List[rl.Collective] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if _in_sharding_prop():
            with _disable_current_modes(), self.fake_mode:
                return func(*args, **kwargs)
        out = func(*args, **kwargs)
        kind = _collective_kind(func)
        if kind is not None:
            self.collectives += [(kind, t.dtype, tuple(t.shape))
                                 for t in _tensors(out)]
        elif not func.is_view and func not in _FREE:
            outs = _tensors(out)
            if outs:
                ins = _tensors((args, kwargs))
                if func in _WRITE_ONLY:
                    ins = ins[1:]
                self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        return out


@dataclasses.dataclass
class Trace:
    """One step traced on one rank."""
    counts: rl.Counts
    peak_bytes: int                 # arguments + temporaries (MemTracker)
    output_bytes: int               # the step's results on the rank
    seconds: float                  # host seconds: state, placement, step
    memory: Dict[str, int]          # MemTracker's peak by category


def _local_bytes(tree) -> int:
    """The bytes of the distinct storages of ``tree``'s tensors on this
    rank (a DTensor's local shard)."""
    seen, total = set(), 0
    for t in _tensors(tree):
        t = t.to_local() if isinstance(t, DTensor) else t
        key = id(t.untyped_storage())
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total


def _step_inputs(cfg, model, seq: int, batch: int, kind: str, mesh,
                 multi_pod: bool, grad_accum: int):
    """(the step, its arguments) for one cell, the arguments fake tensors
    placed on ``mesh`` by their specs."""
    gen = torch.Generator().manual_seed(0)
    inputs = {k: torch.zeros(v.shape, dtype=v.dtype)
              for k, v in input_specs(cfg, seq, batch, kind,
                                      multi_pod).items()}
    in_specs = input_shardings(cfg, kind, multi_pod, batch_size=batch)
    if kind == "train":
        state = place(init_state(model, gen), state_specs(model, multi_pod),
                      mesh)
        step = make_train_step(model, AdamWConfig(), grad_accum=grad_accum)
        return step, (state, place(inputs, in_specs, mesh))
    params = place(model.init(gen), model.param_specs(multi_pod), mesh)
    if kind == "prefill":
        return make_prefill_step(model), (params,
                                          place(inputs, in_specs, mesh))
    cache = place(model.init_cache(batch, seq),
                  model.cache_specs(multi_pod, seq_sharded=(batch == 1),
                                    model_axis=16), mesh)
    tokens = place({"tokens": inputs["tokens"]},
                   {"tokens": in_specs["tokens"]}, mesh)["tokens"]
    # the new token goes to the last slot: it attends the whole cache
    return make_serve_step(model), (params, cache, tokens, seq - 1)


def trace_cell(cfg, model, seq: int, batch: int, kind: str, mesh,
               multi_pod: bool = False, grad_accum: int = 1) -> Trace:
    """One (cfg × shape) step of ``model`` on this process's rank of
    ``mesh`` (a mesh over a fake world, :func:`fake_world`), traced under
    ``FakeTensorMode`` with its counts."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import FlopCounterMode

    t0 = time.perf_counter()
    with FakeTensorMode() as fake:
        step, args = _step_inputs(cfg, model, seq, batch, kind, mesh,
                                  multi_pod, grad_accum)
        flops, comms = FlopCounterMode(display=False), CommDebugMode()
        counter, mem = _RankCounter(fake), MemTracker()
        mem.track_external(*_tensors(args))
        with mem, flops, comms, counter:
            out = step(*args)
        seconds = time.perf_counter() - t0
    calls = {str(k): v for k, v in comms.get_comm_counts().items() if v}
    if sum(calls.values()) != len(counter.collectives):
        raise RuntimeError(f"CommDebugMode counted {calls}, the dry run "
                           f"{len(counter.collectives)} collectives")
    peak = max(mem.get_tracker_snapshot("peak").values(),
               key=lambda d: d.get("Total", 0))
    return Trace(
        counts=rl.Counts(flops=float(flops.get_total_flops()),
                         bytes_accessed=float(counter.bytes),
                         collectives=counter.collectives),
        peak_bytes=int(peak.get("Total", 0)),
        output_bytes=_local_bytes(out),
        seconds=seconds,
        memory={str(k): int(v) for k, v in peak.items()})


@contextlib.contextmanager
def fake_world(n: int, rank: int = 0) -> Iterator[None]:
    """A fake process group of ``n`` ranks in this process, this one rank
    ``rank``; ended on leaving unless it was there before (then this
    process keeps the rank it has there).  Raises beside a process group
    that is not fake, or a fake one of another size.  Worlds of other
    ranks one after another in one process can fail: DTensor's dispatch
    caches keep the meshes, and so the groups' names, of a world that
    ended (one world serves :func:`main`'s cells)."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"the dry run needs a fake process group; a "
                f"{dist.get_backend()!r} group of "
                f"{dist.get_world_size()} ranks is running")
        if dist.get_world_size() != n:
            raise RuntimeError(f"a fake world of {dist.get_world_size()} "
                               f"ranks is running; the dry run needs {n}")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _seq_sharded(model, kind: str, seq_shard_prefill: bool) -> bool:
    """Whether a cell runs context-parallel prefill: the flag, a prefill
    cell and a model with ``act_sharding``, as the JAX package decides."""
    return seq_shard_prefill and kind == "prefill" and \
        hasattr(model, "act_sharding")


# a context-parallel prefill is traced on the rank of the sequence's last
# block on 'model' (rank 15 of the production mesh, the last of the first
# data group): the ranks' work differs there, and that block's queries
# attend every key (rank 0's the fewest)
LAST_BLOCK_RANK = 15


def dryrun_cell(arch: str, shape: str, multi_pod: bool = False,
                remat: str = "full", attn_impl: str = "ref",
                verbose: bool = True, correct_scan_costs: bool = True,
                ssd_dtype: str = "f32", moe_grouped: bool = False,
                parallel_block: bool = False, ssm_chunk: int = 0,
                grad_accum: int = 1, seq_shard_prefill: bool = False
                ) -> Optional[Dict[str, Any]]:
    """One cell's result (the JAX package's keys), or its skip reason.
    ``correct_scan_costs`` is satisfied by eager execution (the module
    docstring) and changes nothing."""
    cfg = get_arch(arch)
    if ssm_chunk:
        cfg = dataclasses.replace(cfg, ssm_chunk=ssm_chunk)
    seq, batch, kind = SHAPES[shape]
    skip = shape_applicable(cfg, shape)
    if skip:
        return {"arch": arch, "shape": shape, "skipped": skip}
    opts = dict(remat_policy=remat, attn_impl=attn_impl,
                ssd_dtype=ssd_dtype, moe_grouped=moe_grouped,
                parallel_block=parallel_block)
    model = build_model(cfg, **opts)
    seq_sharded = _seq_sharded(model, kind, seq_shard_prefill)
    with fake_world(512 if multi_pod else 256,
                    LAST_BLOCK_RANK if seq_sharded else 0):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        n_dev = mesh.size()
        check_widths(cfg, mesh)
        if seq_sharded:
            batch_ax = ("pod", "data") if multi_pod else "data"
            model.act_sharding = placements(P(batch_ax, "model", None),
                                            mesh)
        tr = trace_cell(cfg, model, seq, batch, kind, mesh, multi_pod,
                        grad_accum=grad_accum)
    roof = rl.analyze(tr.counts, cfg, seq, batch, kind, n_dev, remat=remat)

    result = {
        "arch": arch, "shape": shape,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "kind": kind, "seq": seq, "batch": batch,
        "opts": {"remat": remat, "ssd_dtype": ssd_dtype,
                 "moe_grouped": moe_grouped,
                 "parallel_block": parallel_block,
                 "ssm_chunk": ssm_chunk or cfg.ssm_chunk,
                 "grad_accum": grad_accum},
        "lower_s": round(tr.seconds, 2), "compile_s": 0.0,
        "bytes_per_device": tr.peak_bytes,
        "output_bytes": tr.output_bytes,
        "roofline": roof.to_dict(),
    }
    if verbose:
        print(f"[{arch} × {shape} × {result['mesh']}] "
              f"trace={tr.seconds:.1f}s "
              f"mem/dev={result['bytes_per_device']/2**30:.2f}GiB "
              f"compute={roof.compute_s*1e3:.2f}ms "
              f"memory={roof.memory_s*1e3:.2f}ms "
              f"coll={roof.collective_s*1e3:.2f}ms "
              f"dominant={roof.dominant} mfu={roof.mfu:.3f}")
        print("  memory (peak, MemTracker):", tr.memory)
    return result


def host_cell(cfg, seq: int, batch: int, kind: str,
              mesh_shape: Tuple[int, int] = (1, 1), remat: str = "full",
              grad_accum: int = 1,
              seq_shard_prefill: bool = False) -> Dict[str, Any]:
    """One step of ``cfg`` (any depth) on a ("data", "model") mesh of
    ``mesh_shape`` over a fake world of its size, traced as
    :func:`dryrun_cell` traces a production cell (``seq_shard_prefill``
    as there): ``chip_smoke.py``'s one-rank cells, the tests' small
    meshes.  Its own process group, so not beside another."""
    n = mesh_shape[0] * mesh_shape[1]
    model = build_model(cfg, remat_policy=remat, attn_impl="ref")
    seq_sharded = _seq_sharded(model, kind, seq_shard_prefill)
    # context-parallel: the last 'model' rank of the first data group
    with fake_world(n, mesh_shape[1] - 1 if seq_sharded else 0):
        mesh = DeviceMesh("cpu", torch.arange(n).reshape(mesh_shape),
                          mesh_dim_names=("data", "model"))
        check_widths(cfg, mesh)
        if seq_sharded:
            model.act_sharding = placements(P("data", "model", None), mesh)
        tr = trace_cell(cfg, model, seq, batch, kind, mesh,
                        grad_accum=grad_accum)
    roof = rl.analyze(tr.counts, cfg, seq, batch, kind, n, remat=remat)
    return {"arch": cfg.arch_id, "layers": cfg.n_layers,
            "mesh": "x".join(map(str, mesh_shape)), "kind": kind,
            "seq": seq, "batch": batch, "lower_s": round(tr.seconds, 2),
            "bytes_per_device": tr.peak_bytes,
            "output_bytes": tr.output_bytes,
            "counted": {"flops": tr.counts.flops,
                        "bytes": tr.counts.bytes_accessed,
                        "collectives": rl.collective_bytes(
                            tr.counts.collectives)},
            "analytic_flops": rl.analytic_hlo_flops(cfg, seq, batch, kind,
                                                    remat),
            "roofline": roof.to_dict()}


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ALL_ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--remat", default="full", choices=["full", "dots",
                                                        "none"])
    ap.add_argument("--attn-impl", default="ref")
    ap.add_argument("--ssd-dtype", default="f32", choices=["f32", "bf16"])
    ap.add_argument("--moe-grouped", action="store_true")
    ap.add_argument("--parallel-block", action="store_true",
                    help="beyond-paper PaLM-style block (dense/vlm)")
    ap.add_argument("--ssm-chunk", type=int, default=0)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--seq-shard-prefill", action="store_true",
                    help="context-parallel prefill: activations seq-sharded "
                         "over the model axis")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for a in ALL_ARCHS:
            for s in SHAPES:
                cells.append((a, s))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    results = []
    # one world for every cell; as rank LAST_BLOCK_RANK with
    # --seq-shard-prefill (the other cells' ranks are alike)
    with fake_world(512 if args.multi_pod else 256,
                    LAST_BLOCK_RANK if args.seq_shard_prefill else 0):
        for a, s in cells:
            try:
                r = dryrun_cell(a, s, multi_pod=args.multi_pod,
                                remat=args.remat, attn_impl=args.attn_impl,
                                ssd_dtype=args.ssd_dtype,
                                moe_grouped=args.moe_grouped,
                                parallel_block=args.parallel_block,
                                ssm_chunk=args.ssm_chunk,
                                grad_accum=args.grad_accum,
                                seq_shard_prefill=args.seq_shard_prefill)
            except Exception as e:  # noqa: BLE001 — report and continue
                r = {"arch": a, "shape": s,
                     "error": f"{type(e).__name__}: {e}"}
                print(f"[{a} × {s}] FAILED: {r['error']}")
            results.append(r)

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    ok = sum(1 for r in results if "roofline" in r)
    sk = sum(1 for r in results if "skipped" in r)
    err = sum(1 for r in results if "error" in r)
    print(f"\ndry-run: {ok} compiled, {sk} skipped (documented), "
          f"{err} failed")
    if err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
