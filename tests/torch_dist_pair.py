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
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def jax_running(body: str, n_devices: int, *args: str, timeout: int = 300):
    """Run ``body`` in a child interpreter whose JAX sees ``n_devices``
    CPU devices (``args`` its ``sys.argv[1:]``) while the block runs (the
    block gets the process); on leaving the block, wait for it and
    require it to have succeeded."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    prelude = ("import os\nos.environ['XLA_FLAGS'] = "
               f"'--xla_force_host_platform_device_count={n_devices} "
               "--xla_backend_optimization_level=0'\n")
    proc = subprocess.Popen([sys.executable, "-c", prelude + body, *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=ROOT)
    try:
        yield proc
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out + err


def wait_for(path: Path, proc, timeout: float = 300) -> None:
    """Wait until ``path`` exists, which the child ``proc`` writes; fail
    with the child's output if it ends first or ``timeout`` s pass."""
    deadline = time.monotonic() + timeout
    while not path.exists():
        if proc.poll() is not None or time.monotonic() > deadline:
            if proc.poll() is None:
                proc.kill()
            out, err = proc.communicate()
            raise AssertionError(f"{path} never appeared\n{out}{err}")
        time.sleep(0.1)


def spawn(fn, n: int, tmp_path: Path, *args, timeout: float = 600) -> None:
    """``fn(rank, n, *args)`` on ``n`` gloo ranks, one process each; the
    ranks are killed, and the call fails, if they have not all finished
    within ``timeout`` s."""
    store = tmp_path / f"store_{fn.__name__}_{n}"
    ctx = mp.spawn(_rank, args=(fn, n, str(store), args), nprocs=n,
                   join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise AssertionError(f"{fn.__name__} on {n} ranks did not end "
                                 f"within {timeout} s")


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


def pipeline_grad_rank(rank: int, n: int, inputs: str, out: str,
                       n_micro: int, kind: str) -> None:
    """The port's pipelined step and its backward with this rank as stage
    ``rank`` of ``n``: ``inputs``' x (micro, mb, ...) and the output's
    cotangent c, the loss sum(y * c) → ``out % rank``: y, x's gradient and
    this rank's block gradient (``g/`` keys).  ``kind`` "tanh": the layers
    are ``inputs``' w (stages, layers, d, d); "qwen3": the reduced
    qwen3-14b of :func:`pipe_model` with the JAX package's layer
    parameters (``layers/`` keys of the npz at ``inputs`` + ".layers.npz")
    and ``DenseLM._layer_train`` as the layer."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.common import params_from_numpy, tree_map
    from repro_torch.parallel.pipeline import make_pipeline_train_step
    arrays = np.load(inputs)
    if kind == "tanh":
        stages = {"w": torch.from_numpy(arrays["w"])}

        def layer_fn(c, lp):
            return tanh_layer(c, lp["w"])
    else:
        cfg, model = pipe_model()
        stages = tree_map(
            lambda a: a.reshape(n, -1, *a.shape[1:]),
            params_from_numpy(nested(np.load(inputs + ".layers.npz")), cfg,
                              "cpu"))
        pos = torch.arange(arrays["x"].shape[2])

        def layer_fn(c, lp):
            return model._layer_train(c, lp, pos)
    block = tree_map(lambda a: a[rank:rank + 1].clone().requires_grad_(),
                     stages)
    x = torch.from_numpy(arrays["x"]).requires_grad_()
    run = make_pipeline_train_step(layer_fn, n, n_micro,
                                   make_host_mesh(device="cpu"))
    y = run(block, x)
    (y * torch.from_numpy(arrays["c"])).sum().backward()
    np.savez(out % rank, y=y.detach().numpy(), gx=x.grad.numpy(),
             **flat(tree_map(lambda a: a.grad, block), "g/"))


# the reduced qwen3-14b the pipeline's gradients are held on: float32, no
# remat, 4 layers
PIPE_ARCH, PIPE_LAYERS = "qwen3-14b", 4


def pipe_model():
    from repro_torch.configs.registry import ALL_ARCHS, reduced_config
    from repro_torch.models.registry import build_model
    cfg = dataclasses.replace(reduced_config(ALL_ARCHS[PIPE_ARCH]),
                              dtype=torch.float32, n_layers=PIPE_LAYERS)
    return cfg, build_model(cfg, remat_policy="none")


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


# ------------------------------- the ssm, hybrid and audio families' ranks
# The model axis of Mamba2 (mamba2, zamba2's backbone) and whisper's
# heads: the port on gloo ranks against the reference on one device, from
# one initial state.  Prefill tokens (4, 16), frames (B, FAM_FRAMES, d) for
# the audio family, FAM_XKV positions of cross-attention KV from a numpy
# seed in both packages' decode caches.
FAM_FRAMES, FAM_XKV = 24, 24

# the reference on one device: what a job asks for, from the state in
# <dir>/init.npz → <dir>/jax.npz (a string, run by ``jax_running``)
FAMILY_JAX_REF = """
import dataclasses, json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs.registry import ALL_ARCHS, reduced_config
from repro.data.pipeline import SyntheticTokens
from repro.models.registry import build_model
from repro.optim.adamw import AdamWConfig
from repro.train.step import make_prefill_step, make_train_step
sys.path.insert(0, "tests")
from torch_dist_pair import (FAM_FRAMES, FAM_XKV, TP_BATCH, TP_OPT, TP_SEQ,
                             fam_batch, fam_frames, fam_xkv, nested,
                             tp_tokens)

out, job = sys.argv[1], json.loads(sys.argv[2])


def flat(tree, prefix):
    return {prefix + "/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


cfg = dataclasses.replace(reduced_config(ALL_ARCHS[job["arch"]]),
                          dtype=jnp.float32, **job.get("replace", {}))
model = build_model(cfg, remat_policy="none")
state = jax.tree.map(jnp.asarray, nested(np.load(f"{out}/init.npz")))
audio = cfg.family == "audio"
res = {}
if job.get("grads"):
    b = {k: jnp.asarray(v) for k, v in fam_batch(cfg, 0).items()}
    loss, g = jax.jit(jax.value_and_grad(model.loss))(state["params"], b)
    res["grad_loss"] = np.asarray(loss)
    res.update(flat(g, "g/"))
if job.get("logits"):
    toks = jnp.asarray(tp_tokens(cfg, 4, 16))
    fr = jnp.asarray(fam_frames(cfg, 4)) if audio else None
    res["logits"] = np.asarray(jax.jit(model.forward_train)(
        state["params"], toks, fr))
    batch = {"tokens": toks}
    if audio:
        batch["input_embeds"] = fr
    res["prefill"] = np.asarray(jax.jit(make_prefill_step(model))(
        state["params"], batch))
if job.get("decode"):
    b = job.get("batch", 4)
    toks = tp_tokens(cfg, b, job["decode"])
    if audio:
        cache = model.init_cache(b, job["cache"], enc_len=FAM_XKV)
        xk, xv = fam_xkv(cfg, b)
        cache["xk"], cache["xv"] = jnp.asarray(xk), jnp.asarray(xv)
    else:
        cache = model.init_cache(b, job["cache"])
    step, got = jax.jit(model.forward_decode), []
    for i in range(job["decode"]):
        logits, cache = step(state["params"], cache,
                             jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        got.append(np.asarray(logits)[:, -1])
    res["decode"] = np.stack(got)
    res.update(flat(cache, "cache/"))
if job.get("steps"):
    step = jax.jit(make_train_step(model, AdamWConfig(**TP_OPT)))
    losses, norms = [], []
    for i in range(job["steps"]):
        state, m = step(state, {k: jnp.asarray(v)
                                for k, v in fam_batch(cfg, i).items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    res["losses"], res["grad_norms"] = np.array(losses), np.array(norms)
np.savez(f"{out}/jax.npz", **res)
"""


def fam_frames(cfg, b: int, seed: int = 2) -> np.ndarray:
    """Stub-frontend frames (b, FAM_FRAMES, d), float32."""
    return np.random.default_rng(seed).standard_normal(
        (b, FAM_FRAMES, cfg.d_model)).astype(np.float32)


def fam_xkv(cfg, b: int):
    """A cross-attention KV (layers, b, Hkv, FAM_XKV, hd) each, float32."""
    rng = np.random.default_rng(3)
    shape = (cfg.n_layers, b, cfg.n_kv_heads, FAM_XKV, cfg.hd)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for _ in range(2))


def fam_batch(cfg, step: int) -> dict:
    """Training batch ``step``: SyntheticTokens(seq=TP_SEQ,
    batch=TP_BATCH), with frames where the family takes them."""
    from repro_torch.data.pipeline import SyntheticTokens
    b = SyntheticTokens(cfg.vocab, seq=TP_SEQ, batch=TP_BATCH).batch_at(step)
    if cfg.frontend == "audio":
        b["input_embeds"] = fam_frames(cfg, TP_BATCH, seed=10 + step)
    return b


def family_cache(model, cfg, b: int, positions: int):
    """The port's empty decode cache on the CPU (whisper's cross KV
    filled from :func:`fam_xkv`)."""
    if cfg.family != "audio":
        return model.init_cache(b, positions)
    cache = model.init_cache(b, positions, enc_len=FAM_XKV)
    for name, a in zip(("xk", "xv"), fam_xkv(cfg, b)):
        cache[name].copy_(torch.from_numpy(a))
    return cache


def family_rank(rank: int, n: int, job: dict, init: str, out: str) -> None:
    """The port on a (n / shards, shards) mesh of gloo ranks, from the
    state in ``init``: ``job`` as the reference's (``FAMILY_JAX_REF``):
    "grads", "logits", "decode" (that many serve steps from an empty
    cache of ``cache`` positions, batch ``batch`` (4), placed with
    ``seq_sharded`` where asked; then the cache gathered whole), "steps"
    → ``out`` on rank 0 (npz); with "comm", a Mamba2 layer's forward
    under CommDebugMode and the shapes its c10d gathers send."""
    from repro_torch.launch.mesh import (axis_size, full_tree,
                                         make_host_mesh, place)
    from repro_torch.models.common import full, state_from_numpy
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import (make_prefill_step, make_serve_step,
                                        make_train_step, place_inputs,
                                        state_specs, value_and_grad)
    cfg, model = tp_model(job["arch"], job.get("replace", {}))
    mesh = make_host_mesh(job["shards"], device="cpu")
    assert mesh.size() == n, (tuple(mesh.shape), n)
    state = place(state_from_numpy(nested(np.load(init)), cfg, "cpu"),
                  state_specs(model), mesh)
    audio = cfg.family == "audio"
    res = {"mesh": np.array(tuple(mesh.shape))}
    if job.get("grads"):
        loss, g = value_and_grad(model, state["params"], place_inputs(
            model, state["params"], fam_batch(cfg, 0), "train"))
        res["grad_loss"] = np.array(float(full(loss)))
        res.update(flat(full_tree(g), "g/"))
    if job.get("logits"):
        batch = {"tokens": tp_tokens(cfg, 4, 16)}
        if audio:
            batch["input_embeds"] = fam_frames(cfg, 4)
        placed = place_inputs(model, state["params"], batch, "prefill")
        with torch.no_grad():
            logits = model.forward_train(state["params"], placed["tokens"],
                                         placed.get("input_embeds"))
        res["logits"] = full(logits).numpy()
        res["prefill"] = full(make_prefill_step(model)(
            state["params"], batch)).numpy()
    if job.get("decode"):
        b = job.get("batch", 4)
        toks = tp_tokens(cfg, b, job["decode"])
        cache = place(family_cache(model, cfg, b, job["cache"]),
                      model.cache_specs(
                          seq_sharded=job.get("seq_sharded", False),
                          model_axis=axis_size(mesh, "model")), mesh)
        res["cache_specs"] = np.array(sorted(
            f"{k}={t.placements}" for k, t in cache.items()))
        step, got = make_serve_step(model), []
        for i in range(job["decode"]):
            logits, cache = step(state["params"], cache, toks[:, i:i + 1], i)
            got.append(full(logits).numpy())
        res["decode"] = np.stack(got)
        res.update(flat(full_tree(cache), "cache/"))
    if job.get("steps"):
        step = make_train_step(model, AdamWConfig(**TP_OPT))
        losses, norms = [], []
        for i in range(job["steps"]):
            state, m = step(state, fam_batch(cfg, i))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        every = [None] * n
        dist.all_gather_object(every, losses)
        assert all(e == losses for e in every), every
        res["losses"], res["grad_norms"] = np.array(losses), np.array(norms)
    if job.get("comm"):
        res.update(mamba_layer_comms(model, cfg, state["params"]))
    if rank == 0:
        np.savez(out, **res)


def mamba_layer_comms(model, cfg, params) -> dict:
    """One Mamba2 layer's forward and a whole train step's gradient under
    CommDebugMode, and the shapes the port's c10d gathers send in the
    layer's forward."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.models import layers as L
    from repro_torch.models.transformer import layer_params
    from repro_torch.train.step import place_inputs, value_and_grad

    def counts(cm):
        return {str(k).split(".")[-1]: v
                for k, v in cm.get_comm_counts().items() if v}
    batch = place_inputs(model, params, fam_batch(cfg, 0), "train")
    x = L.embed(params["lm"]["embed"], batch["tokens"])
    with torch.no_grad(), CommDebugMode() as cm, gathers() as shapes:
        model._layer_train(x, layer_params(params["layers"], 0))
    with CommDebugMode() as step_cm:
        value_and_grad(model, params, batch)
    return {"layer_comms": np.array(json.dumps(counts(cm))),
            "layer_gathers": np.array(shapes),
            "step_comms": np.array(json.dumps(counts(step_cm)))}


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


def serve_samples(model_shards: int, arch: str = "qwen3-14b") -> list:
    """The "sample:" lines of ``serve.py --legacy`` on reduced ``arch``
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
            arch=arch, reduced=True, batch=2, prompt_len=4, gen=4,
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


def launch_family_state(arch: str):
    """The launcher's initial train state of reduced ``arch`` (seed 0) on
    the CPU, plain tensors."""
    from repro_torch.configs.registry import ALL_ARCHS, reduced_config
    from repro_torch.models.registry import build_model
    from repro_torch.train.step import init_state
    return init_state(build_model(reduced_config(ALL_ARCHS[arch])),
                      torch.Generator().manual_seed(0))


def launch_family_rank(rank, n, arch, d):
    """``launch/train.py`` on reduced ``arch`` with --model-shards 2 (a
    checkpoint at step 2 under ``d``/ckpt) and ``serve.py --legacy
    --model-shards 2``'s samples → ``d``/launch.json (rank 0)."""
    from repro_torch.launch import train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(["--arch", arch, "--reduced", "--batch", "4", "--seq",
                    "16", "--steps", "2", "--model-shards", "2", "--ckpt",
                    f"{d}/ckpt"], device="cpu")
    res = {"train": buf.getvalue(), "serve": serve_samples(2, arch)}
    if rank == 0:
        with open(f"{d}/launch.json", "w") as f:
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


# ------------------------------------------------ context-parallel prefill
# The reference's context-parallel prefill: DenseLM.act_sharding =
# NamedSharding(mesh, P("data", "model", None)) on a (data, model) mesh of 4
# XLA:CPU devices, the prefill step and forward_train jitted with the
# parameters and inputs placed by their specs, for each job of
# <dir>/jobs.json from <dir>/init_<i>.npz → <dir>/jax_<i>.npz
CP_JAX_REF = """
import dataclasses, json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs.registry import ALL_ARCHS, reduced_config
from repro.models.registry import build_model, input_shardings
from repro.train.step import make_prefill_step
sys.path.insert(0, "tests")
from torch_dist_pair import cp_batch, nested

d = sys.argv[1]
jobs = json.load(open(f"{d}/jobs.json"))


def named(mesh, tree):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                        is_leaf=lambda x: isinstance(x, P))


for i, job in enumerate(jobs):
    cfg = dataclasses.replace(reduced_config(ALL_ARCHS[job["arch"]]),
                              dtype=jnp.float32)
    model = build_model(cfg, remat_policy="none")
    mesh = Mesh(np.array(jax.devices()).reshape(job["mesh"]),
                ("data", "model"))
    model.act_sharding = NamedSharding(mesh, P("data", "model", None))
    params = jax.tree.map(jnp.asarray, nested(np.load(f"{d}/init_{i}.npz")))
    batch = {k: jnp.asarray(v) for k, v in cp_batch(cfg, job["s"]).items()}
    p_sh = named(mesh, model.param_specs())
    b_sh = {k: v for k, v in named(mesh, input_shardings(
        cfg, "prefill")).items() if k in batch}
    prefill = jax.jit(make_prefill_step(model), in_shardings=(p_sh, b_sh))
    forward = jax.jit(lambda p, b: model.forward_train(
        p, b["tokens"], b.get("input_embeds")), in_shardings=(p_sh, b_sh))
    np.savez(f"{d}/jax_{i}.npz", prefill=np.asarray(prefill(params, batch)),
             logits=np.asarray(forward(params, batch)))
"""

CP_BATCH = 4


def cp_batch(cfg, s: int) -> dict:
    """A prefill batch of CP_BATCH sequences of ``s`` tokens, with the stub
    vision frontend's patches (s // 8 of them) for the vlm family."""
    batch = {"tokens": tp_tokens(cfg, CP_BATCH, s)}
    if cfg.frontend == "vision":
        batch["input_embeds"] = np.random.default_rng(2).standard_normal(
            (CP_BATCH, s // 8, cfg.d_model)).astype(np.float32)
    return batch


def cp_rank(rank: int, n: int, d: str) -> None:
    """The port's context-parallel prefill on ``n`` gloo ranks for each job
    of ``d``/jobs.json (an arch, a (data, model) mesh and a sequence
    length), from ``d``/init_<i>.npz: the one-rank prefill step and
    ``forward_train`` of the plain parameters, then both with the
    parameters placed on the mesh and ``act_sharding`` the placements of
    P("data", "model", None) → ``d``/port_<i>.npz (rank 0's logits, every
    rank's (Sq, Skv) of each attention call, its DTensor collectives and
    its c10d gathers in the step).  Then, on (1, n), a train step and a
    serve step of a model whose ``act_sharding`` counts its reads →
    ``d``/reads.json."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.launch.mesh import make_host_mesh, place, placements
    from repro_torch.models.common import P, full, params_from_numpy
    from repro_torch.train.step import make_prefill_step, place_inputs
    jobs = json.loads(Path(d, "jobs.json").read_text())
    for i, job in enumerate(jobs):
        cfg, model = tp_model(job["arch"], {})
        params = params_from_numpy(nested(np.load(f"{d}/init_{i}.npz")),
                                   cfg, "cpu")
        batch = cp_batch(cfg, job["s"])
        plain = {k: torch.from_numpy(v) for k, v in batch.items()}
        with torch.no_grad():
            one_prefill = make_prefill_step(model)(params, plain)
            one_logits = model.forward_train(params, plain["tokens"],
                                             plain.get("input_embeds"))
        mesh = make_host_mesh(job["mesh"][1], device="cpu")
        assert tuple(mesh.shape) == tuple(job["mesh"]), tuple(mesh.shape)
        placed = place(params, model.param_specs(), mesh)
        model.act_sharding = placements(P("data", "model", None), mesh)
        with attention_shapes() as shapes, CommDebugMode() as cm, \
                gathers() as sent:
            prefill = make_prefill_step(model)(placed, batch)
        comms = {str(k).split(".")[-1]: v
                 for k, v in cm.get_comm_counts().items() if v}
        inputs = place_inputs(model, placed, batch, "prefill")
        with torch.no_grad():
            logits = model.forward_train(placed, inputs["tokens"],
                                         inputs.get("input_embeds"))
        res = dict(attention=np.array(shapes), comms=json.dumps(comms),
                   gathers=len(sent), logits_placements=str(
                       logits.placements),
                   prefill=full(prefill).numpy(),
                   logits=full(logits).numpy(),
                   one_prefill=one_prefill.numpy(),
                   one_logits=one_logits.numpy())
        np.savez(f"{d}/port_{i}_{rank}.npz", **res)
    reads = attribute_reads(make_host_mesh(n, device="cpu"))
    if rank == 0:
        Path(d, "reads.json").write_text(json.dumps(reads))


@contextlib.contextmanager
def attention_shapes():
    """Within the block, (Sq, Skv) of every call of the flash-attention
    dispatch from the model's layers."""
    from repro_torch.models import layers
    shapes, real = [], layers.fa_ops

    def attention(q, k, v, **kw):
        shapes.append((q.shape[2], k.shape[2]))
        return real.attention(q, k, v, **kw)
    layers.fa_ops = _Patched(real, attention=attention)
    try:
        yield shapes
    finally:
        layers.fa_ops = real


def attribute_reads(mesh) -> dict:
    """Reads of ``act_sharding`` by a train step, a serve step and a
    prefill step of reduced qwen3-14b placed on ``mesh``, the attribute
    set to sequence-sharding placements."""
    from repro_torch.launch.mesh import place, placements
    from repro_torch.models.common import P
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import (init_state, make_prefill_step,
                                        make_serve_step, make_train_step,
                                        state_specs)
    cfg, model = tp_model("qwen3-14b", {})
    reads = {"n": 0}

    class Watched(type(model)):
        @property
        def act_sharding(self):
            reads["n"] += 1
            return self._act

        @act_sharding.setter
        def act_sharding(self, value):
            self._act = value
    model.__class__ = Watched
    model.act_sharding = placements(P("data", "model", None), mesh)
    state = place(init_state(model, torch.Generator().manual_seed(0)),
                  state_specs(model), mesh)
    toks = tp_tokens(cfg, CP_BATCH, 17)
    out = {}
    reads["n"] = 0
    make_train_step(model, AdamWConfig(**TP_OPT))(
        state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    out["train"] = reads["n"]
    reads["n"] = 0
    cache = place(model.init_cache(CP_BATCH, 8), model.cache_specs(
        model_axis=mesh.size(1)), mesh)
    make_serve_step(model)(state["params"], cache, toks[:, :1], 0)
    out["decode"] = reads["n"]
    reads["n"] = 0
    make_prefill_step(model)(state["params"], {"tokens": toks})
    out["prefill"] = reads["n"]
    return out
