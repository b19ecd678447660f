"""The model axis of the audio family (whisper) through DTensor against
the JAX package: the port on gloo ranks against the reference on one
device in a child interpreter, both from one initial state in float32
(``tests/torch_dist_pair.py``'s ``family_rank`` and ``FAMILY_JAX_REF``).

Reduced whisper (2 encoder and 2 decoder layers, 4 heads of 16) on
(1, 4): the encoder's non-causal self-attention, the decoder's
cross-attention on the encoder's memory (whole on every rank of
'model') and, at decode, the cross-attention against a cross KV of
numpy values put into both packages' caches, through the head seams.
With 6 heads over 4 the query heads straddle the shards: the
self-attention's KV cache then takes its sequence on 'model', the cross
KV holds every head on every rank, and each rank attends the whole
heads its columns touch.  Prefill and decode logits, the caches, and one
train step's loss, grad norm and every gradient leaf; limits 1e-4 in
float32, losses and grad norms 2e-4.
"""

import filecmp
import json

import jax
import pytest

from repro_torch.checkpoint.manager import CheckpointManager
from test_torch_ssm_parallel import ALL, against_reference, check_all
from torch_dist_pair import (launch_family_rank, launch_family_state,
                             serve_samples, spawn)

assert jax.devices()[0].platform == "cpu"

ARCH = "whisper-large-v3"
CACHES = ("cache/k", "cache/v", "cache/xk", "cache/xv")


def test_whisper_at_1_4(tmp_path):
    """4 heads over 4: each rank its head, the cross KV's heads on
    'model' beside the query heads."""
    port, want = against_reference(tmp_path, dict(ALL, arch=ARCH, shards=4),
                                   4)
    assert "xk=(Replicate(), Shard(dim=2))" in port["cache_specs"]
    check_all(port, want, CACHES)


def test_whisper_straddled_heads_at_1_4(tmp_path):
    """6 heads over 4 (as whisper's 20 over 16): the prefill's attention
    through ``_straddled_heads``, the self-KV cache sequence-sharded on
    'model', and the decode's cross-attention on a cross KV whole on
    every rank, each rank attending the heads its columns touch."""
    job = dict(ALL, arch=ARCH, shards=4,
               replace={"n_heads": 6, "n_kv_heads": 6})
    port, want = against_reference(tmp_path, job, 4)
    assert {"k=(Replicate(), Shard(dim=3))",
            "xk=(Replicate(), Replicate())"} <= set(port["cache_specs"])
    check_all(port, want, CACHES)


def test_launchers_on_two_ranks(tmp_path):
    """``launch/train.py --model-shards 2`` (frames as the batch's
    ``input_embeds``) and ``serve.py --legacy --model-shards 2`` on 2
    ranks: the checkpoint's files byte-identical to a one-rank manager's
    save of the same state, and the samples the one-rank loop's."""
    spawn(launch_family_rank, 2, tmp_path, ARCH, str(tmp_path))
    res = json.loads((tmp_path / "launch.json").read_text())
    assert "mesh={'data': 1, 'model': 2}" in res["train"], res
    src = tmp_path / "ckpt"
    state = CheckpointManager(str(src)).restore(2, launch_family_state(ARCH))
    one = tmp_path / "one"
    CheckpointManager(str(one)).save(2, state, blocking=True)
    names = sorted(p.name for p in (src / "step_0000000002").iterdir())
    assert len(names) > 10
    _, mismatch, errors = filecmp.cmpfiles(
        src / "step_0000000002", one / "step_0000000002", names,
        shallow=False)
    assert mismatch == [] and errors == [], (mismatch, errors)
    assert res["serve"] and res["serve"] == serve_samples(1, ARCH)


@pytest.mark.parametrize("shards", [2, 4])
def test_cross_kv_spec_follows_the_heads(shards):
    """The cross KV takes its heads on 'model' where the key/value heads
    divide it, else only the batch axes: 20 heads divide 4 and not 16."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.registry import build_model
    model = build_model(get_arch(ARCH))
    for axis, want in ((shards, ("data", "model")), (16, ("data", None))):
        spec = model.cache_specs(model_axis=axis)["xk"]
        assert (spec[1], spec[2]) == want, (axis, spec)
