"""Query heads that do not divide the model axis, against the JAX package.

qwen3-14b's 40 query heads over the production mesh's 16 model shards
leave each rank 2.5 heads of columns: ``models/layers.py::_local_heads``
raised there until the dry run ran the port on that mesh.  Now each rank
gathers q, k and v, attends the whole GQA groups its columns touch and
keeps its own columns (``_straddled_heads``); the sequence-sharded decode
keeps its columns likewise.  Here a reduced qwen3-14b with 6 query heads
and 2 KV heads (1.5 heads a rank) on (1, 4) gloo ranks is held against
the reference on one device, at ``tests/test_torch_tensor_parallel.py``'s
limits (1e-4 in float32; losses 2e-4): prefill and decode logits, step
0's gradients (the q/k norm weights' partial sums included) and one train
step.
"""

import pytest
from test_torch_tensor_parallel import (F32_TOL, LOSS_TOL,
                                        _against_reference, _close)

STRADDLED = {"n_heads": 6, "n_kv_heads": 2}


def test_prefill_and_decode_logits_with_straddled_heads(tmp_path):
    job = dict(arch="qwen3-14b", replace=STRADDLED, shards=4, logits=True,
               decode=4, cache=8)
    port, want = _against_reference(tmp_path, job, 4)
    for k in ("logits", "prefill", "decode"):
        assert port[k].shape == want[k].shape, k
        _close(port[k], want[k], F32_TOL, k)


def test_gradients_and_a_step_with_straddled_heads(tmp_path):
    job = dict(arch="qwen3-14b", replace=STRADDLED, shards=4, grads=True,
               steps=1)
    port, want = _against_reference(tmp_path, job, 4)
    grads = [k for k in want.keys() if k.startswith("g/")]
    assert "g/layers/attn/q_norm" in grads
    for k in grads:
        _close(port[k], want[k], F32_TOL, k)
    _close(port["losses"], want["losses"], LOSS_TOL, "losses")
    _close(port["grad_norms"], want["grad_norms"], LOSS_TOL, "grad norms")


def test_the_query_columns_straddle_heads():
    from repro_torch.configs.registry import get_arch, reduced_config
    import dataclasses
    cfg = dataclasses.replace(reduced_config(get_arch("qwen3-14b")),
                              **STRADDLED)
    assert (cfg.n_heads * cfg.hd) % 4 == 0 and cfg.n_heads % 4 != 0
    from repro_torch.models.layers import local_kv_heads
    with pytest.raises(ValueError, match="do not divide"):
        local_kv_heads(cfg, 4, 0)
