"""Multi-rank runs for ``tests/test_torch_{dp_compressed,
pipeline_parallel,specs,tensor_parallel}.py``: the JAX package on a host
mesh of several CPU devices in a child interpreter (the device count goes
into ``XLA_FLAGS`` before jax is imported, as ``tests/test_pipeline.py``
does), and the port
on gloo ranks started with ``torch.multiprocessing`` over a ``FileStore``
under the test's ``tmp_path`` (no TCP port, so xdist's workers cannot
collide).  The two exchange numpy files; trees travel as flat dicts keyed
by their "/"-joined paths.  This module imports no JAX: the ranks import
it."""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def jax_running(body: str, n_devices: int, *args: str, timeout: int = 300):
    """Run ``body`` in a child interpreter whose JAX sees ``n_devices``
    CPU devices (``args`` its ``sys.argv[1:]``) while the block runs; on
    leaving the block, wait for it and require it to have succeeded."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    prelude = ("import os\nos.environ['XLA_FLAGS'] = "
               f"'--xla_force_host_platform_device_count={n_devices} "
               "--xla_backend_optimization_level=0'\n")
    proc = subprocess.Popen([sys.executable, "-c", prelude + body, *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=ROOT)
    try:
        yield
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out + err


def spawn(fn, n: int, tmp_path: Path, *args) -> None:
    """``fn(rank, n, *args)`` on ``n`` gloo ranks, one process each."""
    store = tmp_path / f"store_{fn.__name__}_{n}"
    mp.spawn(_rank, args=(fn, n, str(store), args), nprocs=n, join=True)


def _rank(rank: int, fn, n: int, store: str, args) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, n),
                            rank=rank, world_size=n)
    try:
        fn(rank, n, *args)
    finally:
        dist.destroy_process_group()


def flat(tree, prefix: str = "") -> dict:
    """A dict tree of tensors as numpy arrays keyed by path."""
    out = {}
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            out.update(flat(tree[key], f"{prefix}{key}/"))
        else:
            out[prefix + key] = tree[key].detach().numpy()
    return out


def nested(arrays, prefix: str = "") -> dict:
    """The arrays under ``prefix`` of a flat dict (or npz) as a tree."""
    out: dict = {}
    for key in arrays.keys():
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            node = out
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = np.asarray(arrays[key])
    return out


# ------------------------------------------------ the compressed DP step
# reduced llama3-8b in float32 without remat, the schedule and data of
# tests/test_compressed_dp.py
DP_ARCH, DP_SEQ, DP_BATCH = "llama3-8b", 32, 4
DP_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=40)


def dp_model():
    from repro_torch.configs.registry import ALL_ARCHS, reduced_config
    from repro_torch.models.registry import build_model
    cfg = dataclasses.replace(reduced_config(ALL_ARCHS[DP_ARCH]),
                              dtype=torch.float32)
    return cfg, build_model(cfg, remat_policy="none")


def dp_rank(rank: int, n: int, init: str, out: str, steps: int,
            fault: str = "") -> None:
    """The port's compressed step on this rank, from the state in
    ``init``, for ``steps`` steps → ``out % rank``: the losses, the
    parameters and this rank's ef after them, and, before the first step,
    this rank's gradients (``g/``) with their quantisation (``q/``,
    ``s/``) at zero error feedback.  ``fault`` "no_div" plants an
    all-reduce of the gradients without the division by the group's
    size."""
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.common import state_from_numpy, tree_map
    from repro_torch.optim import compression
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.dp_compressed import (
        local_rows, make_compressed_dp_train_step)
    from repro_torch.train.step import _batch_on, value_and_grad
    cfg, model = dp_model()
    state = state_from_numpy(nested(np.load(init)), cfg, "cpu")
    mesh = make_host_mesh(device="cpu")
    ds = SyntheticTokens(cfg.vocab, DP_SEQ, DP_BATCH, seed=0)
    _, g = value_and_grad(model, state["params"], _batch_on(
        local_rows(ds.batch_at(0), rank, n), "cpu"))
    q, s, _ = compression.compress_pytree(g, tree_map(torch.zeros_like, g))
    if fault == "no_div":
        real = compression.dist.all_reduce

        def undivided(t, group=None):
            real(t, group=group)
            t.mul_(dist.get_world_size(group))
        compression.dist = _Patched(dist, all_reduce=undivided)
    step = make_compressed_dp_train_step(model, AdamWConfig(**DP_OPT), mesh)
    losses, norms = [], []
    for i in range(steps):
        state, m = step(state, ds.batch_at(i))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    np.savez(out % rank, losses=np.array(losses), grad_norms=np.array(norms),
             **flat(state["params"], "params/"), **flat(state["ef"], "ef/"),
             **flat(g, "g/"), **flat(q, "q/"), **flat(s, "s/"))


class _Patched:
    """A module with some of its attributes replaced."""

    def __init__(self, module, **attrs):
        self._module, self._attrs = module, attrs

    def __getattr__(self, name):
        return self._attrs.get(name, getattr(self._module, name))


# ------------------------------------------------------ the GPipe forward
def tanh_layer(x, w):
    return torch.tanh(x @ w)


def pipeline_rank(rank: int, n: int, inputs: str, out: str,
                  n_micro: int) -> None:
    """The port's pipelined forward with this rank as stage ``rank`` of
    ``n``, on ``inputs``' w (stages, layers, d, d) and x (micro, mb, d)
    → ``out % rank``."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.pipeline import make_pipeline_train_step
    arrays = np.load(inputs)
    w = torch.from_numpy(arrays["w"])
    mesh = make_host_mesh(device="cpu")
    run = make_pipeline_train_step(tanh_layer, n, n_micro, mesh)
    y = run(w[rank:rank + 1], torch.from_numpy(arrays["x"]))
    np.save(out % rank, y.numpy())


# ------------------------------------------------------- meshes and place
def mesh_rank(rank: int, n: int, out: str) -> None:
    """On a world of ``n`` ranks: the host mesh's shape at model_shards 1
    and n, what ``place`` does with the batch on 'data' and the parameters
    on 'model' (each leaf's placements, its local shard against the slice
    of the full tensor, ``full_tree`` bit for bit), the ValueErrors of a
    dimension an axis does not divide and of an axis named twice, and the
    training launcher's run on its data axis of n → ``out % rank``
    (JSON)."""
    from repro_torch.configs.registry import ALL_ARCHS, reduced_config
    from repro_torch.launch import train
    from repro_torch.launch.mesh import full_tree, make_host_mesh, place
    from repro_torch.models.common import P, leaves
    from repro_torch.models.registry import build_model, input_shardings
    cfg = reduced_config(ALL_ARCHS["qwen3-14b"])
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    toks = {"tokens": torch.arange(2 * n * 8, dtype=torch.int32).view(
                2 * n, 8),
            "labels": torch.zeros(2 * n, 8, dtype=torch.int32)}
    res = {}
    for shards, tree, specs, what in (
            (1, toks, input_shardings(cfg, "train"), "batch"),
            (n, params, model.param_specs(), "params")):
        mesh = make_host_mesh(shards, device="cpu")
        res[f"shape_{shards}"] = list(mesh.shape)
        placed = place(tree, specs, mesh)
        res[what] = sorted({str(t.placements) for t in leaves(placed)})
        res[f"{what}_shards_match"] = all(
            torch.equal(t.to_local(), shard_of(full, t))
            for t, full in zip(leaves(placed), leaves(tree)))
        res[f"{what}_full_tree_equal"] = all(
            torch.equal(a, b) for a, b in zip(leaves(full_tree(placed)),
                                              leaves(tree)))
    mesh = make_host_mesh(n, device="cpu")
    for name, t, spec in (("odd", torch.zeros(3, 4), P("model", None)),
                          ("twice", torch.zeros(4, 4), P("model", "model"))):
        try:
            place({"w": t}, {"w": spec}, mesh)
            res[name] = "placed"
        except ValueError as e:
            res[name] = str(e)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = train.main(["--arch", "qwen3-14b", "--reduced", "--steps",
                          "1", "--batch", str(2 * n), "--seq", "8"],
                         device="cpu")
    res["train"] = (got["final_step"], buf.getvalue())
    with open(out % rank, "w") as f:
        json.dump(res, f)


def shard_of(full: torch.Tensor, t) -> torch.Tensor:
    """The slice of ``full`` that DTensor ``t``'s placements give this
    rank (mesh dimensions sharding one tensor dimension taken left to
    right)."""
    from torch.distributed.tensor import Shard
    mesh, index = t.device_mesh, [slice(None)] * full.dim()
    for d in range(full.dim()):
        dims = [i for i, p in enumerate(t.placements)
                if isinstance(p, Shard) and p.dim == d]
        k, pos = 1, 0
        for i in dims:
            k *= mesh.size(i)
            pos = pos * mesh.size(i) + mesh.get_local_rank(i)
        step = full.shape[d] // k
        index[d] = slice(pos * step, (pos + 1) * step)
    return full[tuple(index)]


# -------------------------------- tensor, expert and data parallelism
# tests/test_sharded_numerics.py's setting: reduced llama3-8b in float32
# with 4 KV heads, no remat, this schedule and SyntheticTokens(seq=32,
# batch=8), 8 steps
TP_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)
TP_SEQ, TP_BATCH, TP_STEPS = 32, 8, 8


def tp_model(arch: str, replace: dict):
    from repro_torch.configs.registry import ALL_ARCHS, reduced_config
    from repro_torch.models.registry import build_model
    cfg = dataclasses.replace(reduced_config(ALL_ARCHS[arch]),
                              dtype=torch.float32, **replace)
    return cfg, build_model(cfg, remat_policy="none")


def tp_tokens(cfg, b: int, s: int) -> np.ndarray:
    return np.random.default_rng(1).integers(0, cfg.vocab, (b, s)).astype(
        np.int32)


def tp_rank(rank: int, n: int, job: dict, init: str, out: str) -> None:
    """The port on a (n / shards, shards) mesh of gloo ranks, from the
    state in ``init``: ``job`` says what to read — "grads" (the loss and
    every gradient on step 0's batch, gathered whole), "steps" (that many
    train steps: losses, grad norms, the parameters after), "logits"
    (``forward_train`` on tp_tokens, and the prefill step's last row) and
    "decode" (that many ``serve_step`` calls from an empty cache of
    ``cache`` positions) → ``out`` on rank 0 (npz).  Every rank's losses
    must agree."""
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch.mesh import (axis_size, full_tree,
                                         make_host_mesh, place)
    from repro_torch.models.common import state_from_numpy
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.models.common import full
    from repro_torch.train.step import (make_prefill_step, make_serve_step,
                                        make_train_step, place_inputs,
                                        state_specs, value_and_grad)
    cfg, model = tp_model(job["arch"], job.get("replace", {}))
    mesh = make_host_mesh(job["shards"], device="cpu")
    assert mesh.size() == n, (tuple(mesh.shape), n)
    state = place(state_from_numpy(nested(np.load(init)), cfg, "cpu"),
                  state_specs(model), mesh)
    ds = SyntheticTokens(cfg.vocab, seq=TP_SEQ, batch=TP_BATCH)
    res = {"mesh": np.array(tuple(mesh.shape))}
    if job.get("grads"):
        loss, g = value_and_grad(model, state["params"], place_inputs(
            model, state["params"], ds.batch_at(0), "train"))
        res["grad_loss"] = np.array(float(full(loss)))
        res.update(flat(full_tree(g), "g/"))
    if job.get("logits"):
        toks = tp_tokens(cfg, 4, 16)
        with torch.no_grad():
            logits = model.forward_train(state["params"], place_inputs(
                model, state["params"], {"tokens": toks}, "prefill")[
                    "tokens"])
        res["logits"] = full(logits).numpy()
        res["prefill"] = full(make_prefill_step(model)(
            state["params"], {"tokens": toks})).numpy()
    if job.get("decode"):
        toks = tp_tokens(cfg, 4, job["decode"])
        cache = place(model.init_cache(4, job["cache"]), model.cache_specs(
            model_axis=axis_size(mesh, "model")), mesh)
        step, got = make_serve_step(model), []
        for i in range(job["decode"]):
            logits, cache = step(state["params"], cache, toks[:, i:i + 1], i)
            got.append(full(logits).numpy())
        res["decode"] = np.stack(got)
    if job.get("steps"):
        step = make_train_step(model, AdamWConfig(**TP_OPT))
        losses, norms = [], []
        for i in range(job["steps"]):
            state, m = step(state, ds.batch_at(i))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        every = [None] * n
        dist.all_gather_object(every, losses)
        assert all(e == losses for e in every), every
        res["losses"], res["grad_norms"] = np.array(losses), np.array(norms)
        res.update(flat(full_tree(state["params"]), "params/"))
    if rank == 0:
        np.savez(out, **res)


# ------------------------------------------ the tensor-parallel test's ranks


def place_rank(rank, n, out):
    """(i): the train state of reduced qwen3-moe, a batch and a KV cache
    placed on (1, n) and (n / 2, 2) → ``out % rank`` (JSON: leaves checked
    and those whose placements or local shard are wrong; the draw turns of
    ranks sharing the host and of ranks on devices of their own; reduced
    llama3-8b's logits for a batch of 1 on (1, n) against one rank's)."""
    from unittest import mock

    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.mesh import (draw_turns, full_tree,
                                         make_host_mesh, place)
    from repro_torch.models import common
    from repro_torch.models.common import P, leaves
    from repro_torch.models.registry import input_shardings
    from repro_torch.train.step import init_state, place_inputs, state_specs
    checked, failed = 0, []
    cfg, model = tp_model("qwen3-moe-235b-a22b", {"n_experts": 16})
    dcfg, dense = tp_model("llama3-8b", {"n_kv_heads": 4})
    state = init_state(model, torch.Generator().manual_seed(0))
    trees = [(state, state_specs(model)),
             ({"tokens": torch.arange(32 * 8).view(8, 32)},
              {"tokens": input_shardings(dcfg, "train")["tokens"]}),
             (dense.init_cache(4, 8), dense.cache_specs(model_axis=n))]
    for shards in sorted({n, 2}):
        mesh = make_host_mesh(shards, device="cpu")
        names = mesh.mesh_dim_names
        for tree, specs in trees:
            placed = place(tree, specs, mesh)
            for t, full, spec in zip(leaves(placed), leaves(tree),
                                     leaves(specs)):
                want = [Replicate()] * mesh.ndim
                for i, entry in enumerate(P(*spec)):
                    for a in (entry,) if isinstance(entry, str) else \
                            entry or ():
                        if mesh.size(names.index(a)) > 1:
                            want[names.index(a)] = Shard(i)
                checked += 1
                if tuple(want) != t.placements or not torch.equal(
                        t.to_local(), shard_of(full, t)):
                    failed.append((str(spec), str(t.placements)))
            if not all(torch.equal(a, b) for a, b in zip(
                    leaves(full_tree(placed)), leaves(tree))):
                failed.append("full_tree")
    # the ranks share the host's memory: they draw in turns; ranks each on
    # a device of their own draw at once
    turns = [draw_turns(mesh)]
    with mock.patch.object(mesh_mod, "device_key",
                           lambda m: f"device {dist.get_rank()}"):
        turns.append(draw_turns(mesh))
    # a prefill batch of 1 on (1, n): the batch's 'data' axis of 1 leaves
    # it whole, so the products may view it away
    mesh = make_host_mesh(n, device="cpu")
    params = dense.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(tp_tokens(dcfg, 1, 8))
    want = dense.forward_train(params, toks)
    placed = place(params, dense.param_specs(), mesh)
    got = common.full(dense.forward_train(placed, place_inputs(
        dense, placed, {"tokens": toks}, "prefill")["tokens"]))
    with open(out % rank, "w") as f:
        json.dump({"checked": checked, "failed": failed, "turns": turns,
                   "batch_1_err": float((got - want).abs().max())}, f)


def comm_rank(rank, n, out):
    """(v): the collectives of a dense layer's forward and of the loss
    under CommDebugMode on (1, 4), the all-gathers' shapes with 2 KV heads
    over 4, and the widest local tensor of the cross-entropy → ``out``
    on rank 0 (JSON)."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.launch.mesh import make_host_mesh, place
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import layer_params
    from repro_torch.train.step import place_inputs, value_and_grad

    def counts(cm):
        return {str(k).split(".")[-1]: v
                for k, v in cm.get_comm_counts().items() if v}

    res = {}
    mesh = make_host_mesh(4, device="cpu")
    for arch, replace in (("llama3-8b", {"n_kv_heads": 4}),
                          ("qwen3-14b", {})):
        cfg, model = tp_model(arch, replace)
        params = place(model.init(torch.Generator().manual_seed(0)),
                       model.param_specs(), mesh)
        toks = tp_tokens(cfg, 4, 17)
        batch = place_inputs(model, params, {"tokens": toks[:, :-1],
                                             "labels": toks[:, 1:]}, "train")
        if arch == "llama3-8b":
            x = L.embed(params["lm"]["embed"], batch["tokens"])
            pos = torch.arange(16)
            with CommDebugMode() as cm:
                model._layer_train(x, layer_params(params["layers"], 0), pos)
            res["layer"] = counts(cm)
            with CommDebugMode() as cm:
                model.loss(params, batch)
            res["loss"], res["layers"] = counts(cm), cfg.n_layers
            logits = model.forward_train(params, batch["tokens"])
            res["vocab"] = cfg.vocab_padded
            res["ce_widest_local"] = widest_local(
                TorchDispatchMode, L.cross_entropy, logits, batch["labels"])
        else:
            with CommDebugMode() as cm, gathers() as shapes:
                model.loss(params, batch)
            res["gqa_dtensor_comms"] = counts(cm)
            res["gqa_gathered_shapes"] = sorted({tuple(s) for s in shapes})
            res["gqa_gathers"] = len(shapes)
        with gathers() as shapes:
            model.loss(params, batch)
        res[f"{arch} gathers"] = len(shapes)
        with CommDebugMode() as cm:
            value_and_grad(model, params, batch)
        res[f"{arch} step comms"] = counts(cm)
    if rank == 0:
        with open(out % rank, "w") as f:
            json.dump(res, f)


@contextlib.contextmanager
def gathers():
    """Within the block, the shapes of the tensors the port's gathers
    (``repro_torch.models.common``'s, through c10d, which CommDebugMode
    does not see) send."""
    from repro_torch.models import common as dt
    shapes, real = [], dt.dist

    def all_gather_into_tensor(out, x, group=None):
        shapes.append(list(x.shape))
        return real.all_gather_into_tensor(out, x, group=group)
    dt.dist = _Patched(real, all_gather_into_tensor=all_gather_into_tensor)
    try:
        yield shapes
    finally:
        dt.dist = real


def widest_local(mode_cls, fn, *args) -> int:
    """The largest last dimension of any plain tensor an op of ``fn``
    (run on DTensors) makes outside DTensor's own dispatch."""
    from torch.distributed.tensor import DTensor
    widest = [0]

    class Widest(mode_cls):
        def __torch_dispatch__(self, func, types, args=(), kw=None):
            out = func(*args, **(kw or {}))
            flat_args = [a for a in args if isinstance(a, torch.Tensor)]
            if not any(isinstance(a, DTensor) for a in flat_args) and \
                    isinstance(out, torch.Tensor) and out.dim() >= 1:
                widest[0] = max(widest[0], out.shape[-1])
            return out
    with Widest():
        fn(*args)
    return widest[0]


LAUNCH = ["--arch", "qwen3-14b", "--reduced", "--batch", "4", "--seq", "16"]


def launch_state():
    """The launcher's initial train state (reduced qwen3-14b, seed 0) on
    the CPU, plain tensors."""
    from repro_torch.configs.registry import ALL_ARCHS, reduced_config
    from repro_torch.models.registry import build_model
    from repro_torch.train.step import init_state
    return init_state(build_model(reduced_config(ALL_ARCHS["qwen3-14b"])),
                      torch.Generator().manual_seed(0))


def serve_samples(model_shards: int) -> list:
    """The "sample:" lines of ``serve.py --legacy`` on reduced qwen3-14b
    on ``make_host_mesh(model_shards)``, its reduced config taken in
    float32 (in bfloat16 the random reduced model's one-rank logits hold
    exact ties, which a different order of sums breaks either way)."""
    import argparse
    from unittest import mock

    from repro_torch.launch import serve
    real = serve.reduced_config

    def float32(cfg):
        return dataclasses.replace(real(cfg), dtype=torch.float32)
    buf = io.StringIO()
    with mock.patch.object(serve, "reduced_config", float32), \
            contextlib.redirect_stdout(buf):
        serve._legacy_main(argparse.Namespace(
            arch="qwen3-14b", reduced=True, batch=2, prompt_len=4, gen=4,
            temperature=0.0, device="cpu", model_shards=model_shards))
    return [line for line in buf.getvalue().splitlines()
            if line.startswith("sample:")]


def launch_rank(rank, n, d):
    """(vi): ``launch/train.py`` with --model-shards 4 and 2, a restore of
    the (2, 2) checkpoint placed and plain, the launcher's restart, and
    ``serve.py --legacy --model-shards 4`` → ``d``/launch.json (rank 0)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.registry import ALL_ARCHS, reduced_config
    from repro_torch.launch import train
    from repro_torch.launch.mesh import full_tree, make_host_mesh
    from repro_torch.models.common import leaves
    from repro_torch.models.registry import build_model
    from repro_torch.train.step import init_state
    res = {}

    def run(args):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            train.main(LAUNCH + args, device="cpu")
        return buf.getvalue()
    for shards in (4, 2):
        res[f"out_{shards}"] = run(["--steps", "2", "--model-shards",
                                    str(shards), "--ckpt",
                                    f"{d}/ckpt_{shards}"])
    # restore the (2, 2) run's checkpoint as its launcher would, and again
    # through the launcher: it resumes at step 2
    model = build_model(reduced_config(ALL_ARCHS["qwen3-14b"]))
    mesh = make_host_mesh(2, device="cpu")
    like = init_state(model, torch.Generator().manual_seed(1), mesh=mesh)
    restored = full_tree(CheckpointManager(f"{d}/ckpt_2").restore(2, like))
    plain = CheckpointManager(f"{d}/ckpt_2").restore(2, launch_state())
    res["restored_equal"] = all(torch.equal(a, b) for a, b in zip(
        leaves(restored), leaves(plain)))
    dist.barrier()
    res["restart"] = run(["--steps", "3", "--model-shards", "2", "--ckpt",
                          f"{d}/ckpt_2"])
    res["serve"] = serve_samples(4)
    if rank == 0:
        with open(f"{d}/launch.json", "w") as f:
            json.dump(res, f)


def deferred_rank(rank, n, out):
    """(vii): the ssm, hybrid and audio families through both launchers on
    a model axis of 2 and ``check_family`` on a data axis of 2 → ``out %
    rank`` (JSON: each raise's message)."""
    import argparse

    from repro_torch.configs.registry import ALL_ARCHS
    from repro_torch.launch import serve, train
    from repro_torch.launch.mesh import check_family, make_host_mesh
    res = {}
    for arch in ("mamba2-370m", "zamba2-7b", "whisper-large-v3"):
        for what in ("train", "serve", "data"):
            try:
                if what == "train":
                    train.main(["--arch", arch, "--reduced", "--steps", "1",
                                "--batch", "2", "--seq", "16",
                                "--model-shards", "2"], device="cpu")
                elif what == "serve":
                    serve._legacy_main(argparse.Namespace(
                        arch=arch, reduced=True, batch=2, prompt_len=2,
                        gen=1, temperature=0.0, device="cpu",
                        model_shards=2))
                else:
                    check_family(ALL_ARCHS[arch].family,
                                 make_host_mesh(1, device="cpu"))
                res[f"{arch} {what}"] = "ran"
            except NotImplementedError as e:
                res[f"{arch} {what}"] = str(e)
    with open(out % rank, "w") as f:
        json.dump(res, f)



def card_rank(rank, n, out):
    """The card leg at (1, n): ranks sharing one CUDA card over gloo with
    CUDA tensors; reduced llama3-8b in float32 (4 KV heads, which divide
    the model axis) and reduced qwen3-14b with 1 KV head (which does not:
    k and v gathered as activations, the decode cache sharded along its
    sequence) against the one-rank run of the same weights on the card:
    the loss and every gradient, the forward's and 4 decode steps'
    logits, two train steps; and each kernel launched on every rank →
    ``out % rank`` (JSON)."""
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.rmsnorm import kernel as rk
    from repro_torch.launch.mesh import (axis_size, full_tree,
                                         make_host_mesh, place)
    from repro_torch.models.common import leaves
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.models.common import full
    from repro_torch.models.layers import local_kv_heads
    from repro_torch.train.step import (init_state, make_serve_step,
                                        make_train_step, place_inputs,
                                        value_and_grad)
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    res = {}
    for arch, replace in (("llama3-8b", {"n_kv_heads": 4}),
                          ("qwen3-14b", {"n_kv_heads": 1})):
        cfg, model = tp_model(arch, replace)
        mesh = make_host_mesh(n, device="cuda")
        ds = SyntheticTokens(cfg.vocab, seq=TP_SEQ, batch=TP_BATCH)
        toks = tp_tokens(cfg, 4, 8)
        opt = AdamWConfig(**TP_OPT)

        def run(state, placed):
            params = state["params"]
            batch = place_inputs(model, params, ds.batch_at(0), "train")
            loss, g = value_and_grad(model, params, batch)
            with torch.no_grad():
                logits = model.forward_train(params, place_inputs(
                    model, params, {"tokens": toks}, "prefill")["tokens"])
            cache = model.init_cache(4, 8, device=dev)
            if placed:
                cache = place(cache, model.cache_specs(
                    model_axis=axis_size(mesh, "model")), mesh)
            dec, step = [], make_serve_step(model)
            for i in range(4):
                lg, cache = step(params, cache, toks[:, i:i + 1], i)
                dec.append(full(lg))
            losses = []
            for i in range(2):
                state, m = make_train_step(model, opt)(state, ds.batch_at(i))
                losses.append(float(m["loss"]))
            return (float(full(loss)), [full(t) for t in leaves(
                full_tree(g))], full(logits), torch.stack(dec), losses)

        fa.flash_attention.launches = rk.rmsnorm.launches = 0
        fa.flash_attention_bwd.launches = rk.rmsnorm_bwd.launches = 0
        gen = torch.Generator(device=dev)
        one = run(init_state(model, gen.manual_seed(0)), False)
        launches = {k: [f.launches] for k, f in (
            ("attention", fa.flash_attention), ("rmsnorm", rk.rmsnorm),
            ("attention_bwd", fa.flash_attention_bwd),
            ("rmsnorm_bwd", rk.rmsnorm_bwd))}
        fa.flash_attention.launches = rk.rmsnorm.launches = 0
        fa.flash_attention_bwd.launches = rk.rmsnorm_bwd.launches = 0
        got = run(init_state(model, gen.manual_seed(0), mesh=mesh), True)
        for k, f in (("attention", fa.flash_attention),
                     ("rmsnorm", rk.rmsnorm),
                     ("attention_bwd", fa.flash_attention_bwd),
                     ("rmsnorm_bwd", rk.rmsnorm_bwd)):
            launches[k].append(f.launches)
        res[arch] = dict(
            mesh=list(mesh.shape), launches=launches,
            kv_gathered=local_kv_heads(cfg, n, rank) is not None,
            cache_seq_sharded=model.cache_specs(model_axis=n)["k"][3]
            == "model",
            loss=abs(got[0] - one[0]),
            grads=max(float((a - b).abs().max())
                      for a, b in zip(got[1], one[1])),
            logits=float((got[2] - one[2]).abs().max()),
            decode=float((got[3] - one[3]).abs().max()),
            losses=[abs(a - b) for a, b in zip(got[4], one[4])])
    with open(out % rank, "w") as f:
        json.dump(res, f)
