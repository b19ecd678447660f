"""The model axis of the ssm and hybrid families through DTensor against
the JAX package: the port on gloo ranks (``tests/torch_dist_pair.py``'s
``spawn``) against the reference on one device in a child interpreter
(``jax_running``, ``FAMILY_JAX_REF``), both from one initial state in
float32, parameters carried across by ``params_from_numpy``.

Reduced mamba2 on (1, 2), (1, 4) and (2, 2): at a model axis of 4 its
packed projection's 296 columns go 74 to a rank and its conv's 160
channels 40 to a rank, so every part boundary of ``z | x | B | C | dt``
and of ``x | B | C`` is straddled.  For each: the prefill logits, 4
decode steps' logits with the conv cache and the SSM state after them,
and one train step's loss, grad norm and every gradient leaf against
``jax.grad``.  Reduced zamba2 on (1, 4) likewise, and a batch-1
``seq_sharded`` decode on (2, 2) whose site KV cache holds its heads on
'model' and its sequence on 'data'.  A Mamba2 layer's collectives, the
launchers on 2 ranks, and the width check complete it.  Limits: 1e-4 in
float32, losses and grad norms 2e-4.
"""

import dataclasses
import filecmp
import json

import jax
import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import check_widths
from repro_torch.train.step import init_state
from torch_dist_pair import (FAMILY_JAX_REF, family_rank, flat, jax_running,
                             launch_family_rank, launch_family_state,
                             serve_samples, spawn, tp_model)

assert jax.devices()[0].platform == "cpu"

F32_TOL = 1e-4      # logits, caches and gradients, float32
LOSS_TOL = 2e-4     # losses and grad norms


def against_reference(d, job, n: int):
    """The port on ``n`` gloo ranks and the reference on one device, from
    one initial state → (port npz, reference npz)."""
    _, model = tp_model(job["arch"], job.get("replace", {}))
    state = init_state(model, torch.Generator().manual_seed(0))
    np.savez(d / "init.npz", **flat(state))
    with jax_running(FAMILY_JAX_REF, 1, str(d), json.dumps(job)):
        spawn(family_rank, n, d, job, str(d / "init.npz"),
              str(d / "port.npz"))
    return np.load(d / "port.npz"), np.load(d / "jax.npz")


def close(got, want, tol=F32_TOL, what=""):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def check_all(port, want, cache_keys):
    """Every reading the reference made: logits, decode, the caches, the
    loss, the grad norm and every gradient leaf."""
    for k in ("logits", "prefill", "decode", *cache_keys):
        close(port[k], want[k], what=k)
    for k in ("grad_loss", "losses", "grad_norms"):
        close(port[k], want[k], LOSS_TOL, k)
    keys = sorted(k for k in want.keys() if k.startswith("g/"))
    assert keys == sorted(k for k in port.keys() if k.startswith("g/"))
    for k in keys:
        close(port[k], want[k], what=k)


ALL = dict(logits=True, decode=4, cache=8, grads=True, steps=1)


@pytest.mark.parametrize("mesh", [(1, 2), (1, 4), (2, 2)])
def test_mamba2_against_the_reference(tmp_path, mesh):
    """Reduced mamba2 on (data, model) ranks: prefill and decode logits,
    the conv cache and the SSM state (each rank's block, gathered), one
    train step's loss, grad norm and gradients, the packed projection's,
    the conv's, the gated norm's (split rows) and A_log, D and dt_bias
    among them."""
    job = dict(ALL, arch="mamba2-370m", shards=mesh[1])
    port, want = against_reference(tmp_path, job, mesh[0] * mesh[1])
    assert tuple(port["mesh"]) == mesh
    check_all(port, want, ("cache/conv", "cache/state"))
    assert {"g/layers/mamba/in_proj", "g/layers/mamba/conv_w",
            "g/layers/mamba/norm", "g/layers/mamba/A_log"} <= set(port.keys())


def test_zamba2_at_1_4(tmp_path):
    """Reduced zamba2 (4 heads of 16, one a rank; the shared block after
    layers 0 and 2) on (1, 4): the Mamba2 backbone on 'model' and the
    shared attention and MLP through the head seams."""
    job = dict(ALL, arch="zamba2-7b", shards=4)
    port, want = against_reference(tmp_path, job, 4)
    check_all(port, want, ("cache/conv", "cache/state", "cache/attn_k",
                           "cache/attn_v"))


def test_zamba2_heads_and_sequence_kv_decode(tmp_path):
    """A batch-1 ``seq_sharded`` decode on (2, 2): the site KV cache holds
    its heads on 'model' and its sequence on 'data'.  Six steps into 8
    positions write into both ranks' stretches; each rank decodes its
    heads over its stretch and the softmax runs across the stretches."""
    job = dict(arch="zamba2-7b", shards=2, decode=6, cache=8, batch=1,
               seq_sharded=True)
    port, want = against_reference(tmp_path, job, 4)
    assert "attn_k=(Shard(dim=3), Shard(dim=2))" in port["cache_specs"]
    for k in ("decode", "cache/attn_k", "cache/attn_v", "cache/conv",
              "cache/state"):
        close(port[k], want[k], what=k)


def test_a_mamba2_layer_moves_no_weight(tmp_path):
    """Under CommDebugMode on (1, 4), one Mamba2 layer's forward is two
    c10d gathers (the packed projection's 74 columns a rank and the
    conv's 40 channels, activations of (B, S, ·) sent with that axis
    first), one all-reduce of a float32 a row (the split-row norm) and
    one reduce (``out_proj``): no weight moves, and no DTensor all-gather
    runs in the whole step."""
    job = dict(arch="mamba2-370m", shards=4, comm=True)
    spawn(family_rank, 4, tmp_path, job, _init(tmp_path, job),
          str(tmp_path / "port.npz"))
    port = np.load(tmp_path / "port.npz")
    assert json.loads(str(port["layer_comms"])) == {
        "_allgather_base_": 2, "all_reduce": 2}
    assert port["layer_gathers"].tolist() == [[74, 8, 32], [40, 8, 32]]
    step = json.loads(str(port["step_comms"]))
    assert "all_gather_into_tensor" not in step, step


def _init(d, job) -> str:
    _, model = tp_model(job["arch"], job.get("replace", {}))
    state = init_state(model, torch.Generator().manual_seed(0))
    np.savez(d / "init.npz", **flat(state))
    return str(d / "init.npz")


class _Mesh:
    """What ``check_widths`` reads of a mesh."""

    def __init__(self, model):
        self.mesh_dim_names, self._sizes = ("data", "model"), (1, model)

    def size(self, i):
        return self._sizes[i]


def test_widths_the_model_axis_does_not_divide_raise():
    """A Mamba2 block whose heads, conv channels or packed width 'model'
    does not divide is refused, naming the width; the full-size configs
    divide at 16."""
    from repro_torch.configs.registry import get_arch, reduced_config
    for arch in ("mamba2-370m", "zamba2-7b"):
        check_widths(get_arch(arch), _Mesh(16))
    cfg = reduced_config(get_arch("mamba2-370m"))       # 8 heads
    check_widths(cfg, _Mesh(4))
    with pytest.raises(ValueError, match="heads = 8 does not divide over "
                                         "'model' = 16"):
        check_widths(cfg, _Mesh(16))
    with pytest.raises(ValueError, match="conv channels di \\+ 2n = 146 "
                                         "does not divide over 'model' = 4"):
        check_widths(dataclasses.replace(cfg, ssm_state=9), _Mesh(4))
    check_widths(get_arch("whisper-large-v3"), _Mesh(16))   # no Mamba2


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-7b"])
def test_launchers_on_two_ranks(tmp_path, arch):
    """``launch/train.py --model-shards 2`` and ``serve.py --legacy
    --model-shards 2`` on 2 ranks: the checkpoint's files byte-identical
    to a one-rank manager's save of the same state, and the samples the
    one-rank loop's."""
    from repro_torch.checkpoint.manager import CheckpointManager
    spawn(launch_family_rank, 2, tmp_path, arch, str(tmp_path))
    res = json.loads((tmp_path / "launch.json").read_text())
    assert "mesh={'data': 1, 'model': 2}" in res["train"], res
    src = tmp_path / "ckpt"
    state = CheckpointManager(str(src)).restore(
        2, launch_family_state(arch))
    one = tmp_path / "one"
    CheckpointManager(str(one)).save(2, state, blocking=True)
    names = sorted(p.name for p in (src / "step_0000000002").iterdir())
    assert len(names) > 10
    _, mismatch, errors = filecmp.cmpfiles(
        src / "step_0000000002", one / "step_0000000002", names,
        shallow=False)
    assert mismatch == [] and errors == [], (mismatch, errors)
    assert res["serve"] and res["serve"] == serve_samples(1, arch)
