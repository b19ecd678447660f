"""Context-parallel prefill (``DenseLM.act_sharding``: the layer-boundary
activations' sequence on 'model') against the JAX package: the port on 4
gloo ranks (``tests/torch_dist_pair.py``'s ``cp_rank``) beside its own
one-rank run, and the reference's ``make_prefill_step`` and
``forward_train`` with ``act_sharding = NamedSharding(mesh, P("data",
"model", None))`` on 4 XLA:CPU devices of the same mesh
(``CP_JAX_REF``), both from one set of parameters, in float32.

The cases: reduced qwen3-14b (dense, 2 KV heads) on (1, 4) and (2, 2) and
at S=30 on (1, 4), whose blocks of 8, 8, 8 and 6 positions 'model' does
not divide evenly; reduced qwen3-moe-235b-a22b on (1, 4) and (2, 2);
reduced mixtral-8x22b (a 16-position window) on (1, 4); reduced
internvl2-76b (vlm, the stub frontend's patches) on (1, 4) and (2, 2).
Each job runs in one spawn of the 4 ranks, and the reference's jobs in one
child interpreter meanwhile.
"""

import json

import jax
import numpy as np
import pytest

from repro_torch.models.registry import build_model
from torch_dist_pair import (CP_JAX_REF, flat, jax_running, spawn, cp_rank,
                             tp_model)

assert jax.devices()[0].platform == "cpu"

F32_TOL = 1e-4      # ROADMAP.md's limit for models in float32

# (arch, (data, model), S)
JOBS = (("qwen3-14b", (1, 4), 32), ("qwen3-14b", (2, 2), 32),
        ("qwen3-14b", (1, 4), 30),
        ("qwen3-moe-235b-a22b", (1, 4), 32),
        ("qwen3-moe-235b-a22b", (2, 2), 32),
        ("mixtral-8x22b", (1, 4), 32),
        ("internvl2-76b", (1, 4), 32), ("internvl2-76b", (2, 2), 32))
RANKS = 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' runs of every job: {job index: (the ranks' npz
    files, the reference's npz)}, and the attribute's reads."""
    import torch
    d = tmp_path_factory.mktemp("context_parallel")
    jobs = [dict(arch=a, mesh=list(m), s=s) for a, m, s in JOBS]
    (d / "jobs.json").write_text(json.dumps(jobs))
    for i, job in enumerate(jobs):
        cfg, model = tp_model(job["arch"], {})
        params = model.init(torch.Generator().manual_seed(i))
        np.savez(d / f"init_{i}.npz", **flat(params))
    with jax_running(CP_JAX_REF, RANKS, str(d), timeout=600):
        spawn(cp_rank, RANKS, d, str(d))
    out = {i: ([np.load(d / f"port_{i}_{r}.npz") for r in range(RANKS)],
               np.load(d / f"jax_{i}.npz")) for i in range(len(jobs))}
    return out, json.loads((d / "reads.json").read_text())


def _close(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL,
                               err_msg=what)


def _blocks(s: int, shards: int):
    """(start, length) of each 'model' rank's block, as torch.chunk
    splits S."""
    step = -(-s // shards)
    return [(r * step, max(0, min(step, s - r * step)))
            for r in range(shards)]


@pytest.mark.parametrize("i", range(len(JOBS)),
                         ids=[f"{a}-{m[0]}x{m[1]}-S{s}" for a, m, s in JOBS])
def test_prefill_matches_one_rank_and_the_reference(runs, i):
    """The prefill step's last-position logits and ``forward_train``'s
    whole logits (gathered along the sequence) on 4 ranks, within 1e-4 of
    the port's one-rank run and of the reference's constrained steps; the
    whole logits come back sharded along the sequence."""
    (ranks, want) = runs[0][i]
    got = ranks[0]
    for k, ref in (("prefill", "prefill"), ("logits", "logits")):
        _close(got[k], got[f"one_{k}"], f"{k} against one rank")
        _close(got[k], want[ref], f"{k} against the reference")
    assert "Shard(dim=1)" in str(got["logits_placements"])


@pytest.mark.parametrize("i", range(len(JOBS)),
                         ids=[f"{a}-{m[0]}x{m[1]}-S{s}" for a, m, s in JOBS])
def test_each_rank_attends_its_block_against_the_key_prefix(runs, i):
    """Every attention call of rank r takes its block's queries and the
    keys up to its block's end: (n_r, s0_r + n_r), one call a layer."""
    arch, mesh, s = JOBS[i]
    layers = tp_model(arch, {})[0].n_layers
    blocks = _blocks(s, mesh[1])
    for r, got in enumerate(runs[0][i][0]):
        s0, n = blocks[r % mesh[1]]
        assert got["attention"].tolist() == [[n, s0 + n]] * layers, (r, got[
            "attention"])


def _collectives(arch: str, mesh) -> dict:
    """The collectives of one prefill step on a rank: c10d gathers (the
    embedding table once; each layer's weights that 'model' shards, its
    rotated keys and values, and for moe the activations along the
    sequence, plus the ranks' tokens-per-expert counts where the batch is
    on 'data') and DTensor all-reduces (the last position's masked sum;
    for moe each layer's combine)."""
    cfg = tp_model(arch, {})[0]
    model = build_model(cfg)
    attn = 4                                    # wq, wk, wv, wo
    if cfg.family == "moe":
        per_layer = attn + 2 + 1 + (mesh[0] > 1)
        reduces = cfg.n_layers + 1
    else:
        per_layer = attn + 2 + len(model.param_specs()["layers"]["mlp"])
        reduces = 1
    return {"gathers": 1 + cfg.n_layers * per_layer, "all_reduce": reduces}


@pytest.mark.parametrize("i", range(len(JOBS)),
                         ids=[f"{a}-{m[0]}x{m[1]}-S{s}" for a, m, s in JOBS])
def test_the_step_gathers_through_c10d_alone(runs, i):
    """The step's gathers are the port's c10d ones (DTensor's functional
    all-gather crashes gloo on CUDA tensors): no DTensor all-gather, and
    exactly the gathers and all-reduces of :func:`_collectives` — no
    per-layer all-reduce of a dense layer's residual."""
    arch, mesh, _ = JOBS[i]
    want = _collectives(arch, mesh)
    for r, got in enumerate(runs[0][i][0]):
        comms = json.loads(str(got["comms"]))
        assert "all_gather_into_tensor" not in comms, (r, comms)
        assert int(got["gathers"]) == want["gathers"], (r, int(got[
            "gathers"]), want)
        assert comms.get("all_reduce", 0) == want["all_reduce"], (r, comms)


def test_train_and_decode_never_read_the_attribute(runs):
    """A train step and a serve step of a model whose ``act_sharding`` is
    set never read it; the prefill step does."""
    reads = runs[1]
    assert reads["train"] == 0 and reads["decode"] == 0, reads
    assert reads["prefill"] > 0, reads
