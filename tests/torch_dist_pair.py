"""Multi-rank runs for ``tests/test_torch_{dp_compressed,
pipeline_parallel}.py``: the JAX package on a host mesh of several CPU
devices in a child interpreter (the device count goes into ``XLA_FLAGS``
before jax is imported, as ``tests/test_pipeline.py`` does), and the port
on gloo ranks started with ``torch.multiprocessing`` over a ``FileStore``
under the test's ``tmp_path`` (no TCP port, so xdist's workers cannot
collide).  The two exchange numpy files; trees travel as flat dicts keyed
by their "/"-joined paths.  This module imports no JAX: the ranks import
it."""

import contextlib
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
    import dataclasses

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
    and n, and what ``place`` and the training launcher do with an axis
    above 1 → ``out % rank`` (JSON)."""
    import json

    from repro_torch.configs.registry import ALL_ARCHS, reduced_config
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh, place
    from repro_torch.models.registry import build_model, input_shardings
    cfg = reduced_config(ALL_ARCHS["qwen3-14b"])
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    toks = {"tokens": torch.zeros(2 * n, 8, dtype=torch.int32),
            "labels": torch.zeros(2 * n, 8, dtype=torch.int32)}
    res = {}
    for shards, tree, specs, what in (
            (1, toks, input_shardings(cfg, "train"), "batch"),
            (n, params, model.param_specs(), "params")):
        mesh = make_host_mesh(shards, device="cpu")
        res[f"shape_{shards}"] = list(mesh.shape)
        try:
            place(tree, specs, mesh)
            res[what] = "placed"
        except NotImplementedError as e:
            res[what] = str(e)
    try:
        train.main(["--arch", "qwen3-14b", "--reduced", "--steps", "1"],
                   device="cpu")
        res["train"] = "ran"
    except NotImplementedError as e:
        res["train"] = str(e)
    with open(out % rank, "w") as f:
        json.dump(res, f)
