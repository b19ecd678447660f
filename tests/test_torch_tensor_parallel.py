"""Tensor, expert and data parallelism through DTensor against the JAX
package: the port on gloo ranks (``tests/torch_dist_pair.py``'s ``spawn``,
a ``FileStore`` under ``tmp_path``) against the reference on one device in
a child interpreter (``jax_running``), both from one initial state.

  (i)   ``place`` on 2 and 4 ranks: placements, local shards, ``full_tree``;
  (ii)  tests/test_sharded_numerics.py's training on (1, 1), (1, 4) and
        (2, 4): losses within 2e-4 of the reference's single-device ones,
        the grad norms, and every gradient leaf of step 0 against
        ``jax.grad``, the replicated norm weights included;
  (iii) prefill and decode logits at (1, 4), key/value heads that divide
        the model axis and that do not;
  (iv)  MoE at (1, 4), experts over 'model' (16) and each expert's FFN
        over it (4): logits and one train step;
  (v)   no collective moves a weight of the forward, and the
        cross-entropy never holds the whole vocabulary on a rank;
  (vi)  the launchers on 4 ranks: meshes, checkpoints byte-identical to a
        one-rank run's, a restart, the legacy serve loop's samples;
  (vii) the ssm, hybrid and audio families raise on an axis above 1.
"""

import filecmp
import json

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import SSM_MODEL_AXIS_ITEM
from repro_torch.train.step import init_state
from torch_dist_pair import (TP_BATCH, TP_OPT, TP_SEQ, TP_STEPS, comm_rank,
                             deferred_rank, flat, jax_running, launch_rank,
                             launch_state, place_rank, serve_samples,
                             spawn, tp_model, tp_rank)

assert jax.devices()[0].platform == "cpu"

F32_TOL = 1e-4      # logits and gradients, float32
LOSS_TOL = 2e-4     # tests/test_sharded_numerics.py's limit

# the reference on one device: what a job asks for, from the state in
# <dir>/init.npz → <dir>/jax.npz
JAX_REF = """
import dataclasses, json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs.registry import ALL_ARCHS, reduced_config
from repro.data.pipeline import SyntheticTokens
from repro.models.registry import build_model
from repro.optim.adamw import AdamWConfig
from repro.train.step import make_prefill_step, make_train_step

out, job = sys.argv[1], json.loads(sys.argv[2])
seq, batch, opt = int(sys.argv[3]), int(sys.argv[4]), json.loads(sys.argv[5])


def nested(arrays):
    tree = {}
    for key in arrays.keys():
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(arrays[key])
    return tree


def flat(tree, prefix):
    return {prefix + "/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


cfg = dataclasses.replace(reduced_config(ALL_ARCHS[job["arch"]]),
                          dtype=jnp.float32, **job.get("replace", {}))
model = build_model(cfg, remat_policy="none")
state = nested(np.load(f"{out}/init.npz"))
ds = SyntheticTokens(cfg.vocab, seq=seq, batch=batch)
res = {}
rng = np.random.default_rng(1)
if job.get("grads"):
    b = {k: jnp.asarray(v) for k, v in ds.batch_at(0).items()}
    loss, g = jax.jit(jax.value_and_grad(model.loss))(state["params"], b)
    res["grad_loss"] = np.asarray(loss)
    res.update(flat(g, "g/"))
if job.get("logits"):
    toks = jnp.asarray(np.random.default_rng(1).integers(
        0, cfg.vocab, (4, 16)).astype(np.int32))
    res["logits"] = np.asarray(jax.jit(model.forward_train)(
        state["params"], toks))
    res["prefill"] = np.asarray(jax.jit(make_prefill_step(model))(
        state["params"], {"tokens": toks}))
if job.get("decode"):
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab, (4, job["decode"])).astype(np.int32)
    cache = model.init_cache(4, job["cache"])
    step, got = jax.jit(model.forward_decode), []
    for i in range(job["decode"]):
        logits, cache = step(state["params"], cache,
                             jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        got.append(np.asarray(logits)[:, -1])
    res["decode"] = np.stack(got)
if job.get("steps"):
    step = jax.jit(make_train_step(model, AdamWConfig(**opt)))
    losses, norms = [], []
    for i in range(job["steps"]):
        state, m = step(state, {k: jnp.asarray(v)
                                for k, v in ds.batch_at(i).items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    res["losses"], res["grad_norms"] = np.array(losses), np.array(norms)
    res.update(flat(state["params"], "params/"))
np.savez(f"{out}/jax.npz", **res)
"""


def _init(d, job):
    """The port's initial state for ``job`` in ``d``/init.npz."""
    cfg, model = tp_model(job["arch"], job.get("replace", {}))
    state = init_state(model, torch.Generator().manual_seed(0))
    np.savez(d / "init.npz", **flat(state))
    return cfg, model


def _against_reference(d, job, n: int):
    """The port on ``n`` gloo ranks and the reference on one device, from
    one initial state → (port npz, reference npz)."""
    _init(d, job)
    with jax_running(JAX_REF, 1, str(d), json.dumps(job), str(TP_SEQ),
                     str(TP_BATCH), json.dumps(TP_OPT)):
        spawn(tp_rank, n, d, job, str(d / "init.npz"), str(d / "port.npz"))
    return np.load(d / "port.npz"), np.load(d / "jax.npz")


def _close(got, want, tol=F32_TOL, what=""):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


# ------------------------------------------------------------ (i) placing

@pytest.mark.parametrize("n", [2, 4])
def test_place_gives_each_leaf_its_spec_on_ranks(tmp_path, n):
    """On 2 and 4 ranks the whole train state of reduced qwen3-moe (16
    experts, over 'model') and the batch and cache of reduced llama3-8b
    are placed on (1, n) and (n/2, 2): each leaf's placements are its
    spec's, each local shard the matching slice of the full tensor, and
    ``full_tree`` gives the full tensors back bit for bit.  Ranks that
    share a device draw in turns, in rank order; ranks each on a device
    of their own draw at once.  An axis of 1 that a spec names leaves the
    dimension whole: a prefill batch of 1 on (1, n) runs, its logits
    within 1e-4 of one rank's."""
    spawn(place_rank, n, tmp_path, str(tmp_path / "place_%d.json"))
    for r in range(n):
        res = json.loads((tmp_path / f"place_{r}.json").read_text())
        assert res["checked"] >= 49 and res["failed"] == [], res
        assert res["turns"] == [[r, n], [0, 1]], res
        assert res["batch_1_err"] <= F32_TOL, res


# ----------------------------------------------------------- (ii) training

TRAIN_JOB = dict(arch="llama3-8b", replace={"n_kv_heads": 4}, grads=True,
                 steps=TP_STEPS)


@pytest.mark.parametrize("mesh", [(1, 1), (1, 4), (2, 4)])
def test_training_matches_the_reference_single_device(tmp_path, mesh):
    """tests/test_sharded_numerics.py's run through the port: 8 steps of
    reduced llama3-8b on (data, model) gloo ranks within 2e-4 of the
    reference's single-device losses (its own test holds those equal to
    its (2, 4) run), the grad norms as well, and every gradient of step 0
    against ``jax.grad`` leaf by leaf: q_norm/k_norm (where the config
    has them), ln1/ln2 and final_norm are replicated weights applied to
    sharded activations, whose gradients are partial sums a rank."""
    job = dict(TRAIN_JOB, shards=mesh[1])
    port, want = _against_reference(tmp_path, job, mesh[0] * mesh[1])
    assert tuple(port["mesh"]) == mesh
    _close(port["losses"], want["losses"], LOSS_TOL, "losses")
    _close(port["grad_norms"], want["grad_norms"], LOSS_TOL, "grad norms")
    _close(port["grad_loss"], want["grad_loss"], LOSS_TOL, "step 0 loss")
    keys = sorted(k for k in want.keys() if k.startswith("g/"))
    assert keys == sorted(k for k in port.keys() if k.startswith("g/"))
    assert {"g/layers/ln1", "g/layers/ln2", "g/lm/final_norm"} <= set(keys)
    for k in keys:
        _close(port[k], want[k], F32_TOL, k)
    for k in (k for k in want.keys() if k.startswith("params/")):
        _close(port[k], want[k], 1e-3, k)


def test_replicated_norm_weights_of_sharded_heads(tmp_path):
    """Reduced qwen3-14b (q_norm and k_norm, 2 KV heads gathered over a
    model axis of 4) on (2, 2): step 0's gradients, the norm weights'
    included, against ``jax.grad``, and one train step's loss."""
    job = dict(arch="qwen3-14b", shards=2, grads=True, steps=1)
    port, want = _against_reference(tmp_path, job, 4)
    for k in ("g/layers/attn/q_norm", "g/layers/attn/k_norm",
              "g/layers/ln1", "g/lm/embed", "g/layers/attn/wk"):
        _close(port[k], want[k], F32_TOL, k)
    for k in (k for k in want.keys() if k.startswith("g/")):
        _close(port[k], want[k], F32_TOL, k)
    _close(port["losses"], want["losses"], LOSS_TOL, "losses")


# ----------------------------------------------------- (iii) prefill, decode

@pytest.mark.parametrize("arch,replace", [
    ("qwen3-14b", {}),                      # 2 KV heads over 4: sequence
    ("llama3-8b", {"n_kv_heads": 4})])      # 4 KV heads over 4: heads
def test_prefill_and_decode_logits_at_1_4(tmp_path, arch, replace):
    """``forward_train``, the prefill step's last row and 4 decode steps
    (an 8-position cache: its heads on 'model' where the KV heads divide
    it, else its sequence) within 1e-4 of the reference."""
    job = dict(arch=arch, replace=replace, shards=4, logits=True,
               decode=4, cache=8)
    port, want = _against_reference(tmp_path, job, 4)
    for k in ("logits", "prefill", "decode"):
        assert port[k].shape == want[k].shape, k
        _close(port[k], want[k], F32_TOL, k)


# ------------------------------------------------------------------ (iv) MoE

@pytest.mark.parametrize("experts", [16, 4])
def test_moe_at_1_4(tmp_path, experts):
    """Reduced qwen3-moe: 16 experts shard over 'model' (4 a rank), 4 do
    not, and each expert's FFN columns do: logits, decode, and one train
    step (loss, grad norm, parameters) against the reference."""
    job = dict(arch="qwen3-moe-235b-a22b", replace={"n_experts": experts},
               shards=4, logits=True, decode=4, cache=8, steps=1)
    port, want = _against_reference(tmp_path, job, 4)
    for k in ("logits", "prefill", "decode"):
        _close(port[k], want[k], F32_TOL, k)
    _close(port["losses"], want["losses"], LOSS_TOL, "losses")
    _close(port["grad_norms"], want["grad_norms"], LOSS_TOL, "grad norms")
    for k in (k for k in want.keys() if k.startswith("params/")):
        _close(port[k], want[k], 1e-3, k)


# -------------------------------------------------------- (v) communication

def test_the_forward_moves_no_weight(tmp_path):
    """Under CommDebugMode on (1, 4): a dense layer's forward is 2
    all-reduces (attention's and the MLP's row-parallel outputs) and
    nothing else; the whole loss adds the embedding's all-reduce and the
    cross-entropy's three (max, sum of exponentials, label logit; the
    mean is local on a data axis of 1), with no all-gather: no weight
    moves.  With 2 KV heads over 4 the only
    all-gathers (the port's own, through c10d) are the projected keys and
    values, activations of (B, S, hkv * hd / 4) sent with that last axis
    first; with 4 KV heads there is none.  A whole step, backward and
    gradients' reductions included, makes no DTensor all-gather (DTensor's
    all-gather crashes gloo on CUDA tensors under torch 2.11).  The
    cross-entropy's local ops never see the whole vocabulary."""
    spawn(comm_rank, 4, tmp_path, str(tmp_path / "comm_%d.json"))
    res = json.loads((tmp_path / "comm_0.json").read_text())
    assert res["layer"] == {"all_reduce": 2}, res
    assert res["loss"]["all_reduce"] == 1 + 2 * res["layers"] + 3, res
    assert "all_gather_into_tensor" not in res["loss"], res
    assert "all_gather_into_tensor" not in res["gqa_dtensor_comms"], res
    assert res["llama3-8b gathers"] == 0, res
    assert res["gqa_gathers"] == res["qwen3-14b gathers"] == \
        2 * res["layers"], res
    assert res["gqa_gathered_shapes"] == [[8, 4, 16]], res
    assert res["gqa_dtensor_comms"]["_allgather_base_"] == 2 * res["layers"]
    for arch in ("llama3-8b", "qwen3-14b"):
        assert "all_gather_into_tensor" not in res[f"{arch} step comms"], res
    assert set(res["llama3-8b step comms"]) == {"all_reduce"}, res
    assert res["ce_widest_local"] == res["vocab"] // 4, res


# ------------------------------------------------------------ (vi) launchers

def test_launchers_on_four_ranks(tmp_path):
    """``launch/train.py`` on 4 ranks with --model-shards 4 and 2 prints
    its mesh, writes a checkpoint whose files are byte-identical to a
    one-rank manager's of the same state, restarts from it (resumed at
    its step, the restored state bit-identical); ``serve.py --legacy
    --model-shards 4`` prints the one-rank run's samples (float32 weights,
    :func:`serve_samples`)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    spawn(launch_rank, 4, tmp_path, str(tmp_path))
    res = json.loads((tmp_path / "launch.json").read_text())
    assert "mesh={'data': 1, 'model': 4}" in res["out_4"], res
    assert "mesh={'data': 2, 'model': 2}" in res["out_2"], res
    assert "resumed=True start=2" in res["restart"], res
    assert res["restored_equal"], res
    for shards in (4, 2):
        src = tmp_path / f"ckpt_{shards}"
        state = CheckpointManager(str(src)).restore(2, launch_state())
        one = tmp_path / f"one_{shards}"
        CheckpointManager(str(one)).save(2, state, blocking=True)
        names = sorted(p.name for p in (src / "step_0000000002").iterdir())
        assert len(names) > 20
        match, mismatch, errors = filecmp.cmpfiles(
            src / "step_0000000002", one / "step_0000000002", names,
            shallow=False)
        assert mismatch == [] and errors == [], (mismatch, errors)
    one_rank = serve_samples(1)
    assert not dist.is_initialized()
    assert one_rank and res["serve"] == one_rank, (res["serve"], one_rank)


# ---------------------------------------------------- (vii) deferred families

def test_deferred_families_raise_on_an_axis_above_one(tmp_path):
    """mamba2 (ssm), zamba2 (hybrid) and whisper (audio) on a model axis of
    2: the training and serving launchers raise NotImplementedError
    naming the ROADMAP.md item, before any work; on a data axis of 2
    likewise."""
    spawn(deferred_rank, 2, tmp_path, str(tmp_path / "deferred_%d.json"))
    for r in range(2):
        res = json.loads((tmp_path / f"deferred_{r}.json").read_text())
        assert len(res) == 9, res
        assert all(SSM_MODEL_AXIS_ITEM in v for v in res.values()), res
