"""The card leg of tests/test_torch_tensor_parallel.py: two ranks share
one CUDA card over a gloo group with CUDA tensors (NCCL refuses two ranks
on one device), a (1, 2) mesh, held against the one-rank run of the same
weights on the card, the kernels launched on each rank's shards.  No JAX
here: the reference is the port's own one-rank run.  Skips without a
card."""

import json

import pytest
import torch

from torch_dist_pair import card_rank, spawn

TOL = 1e-4


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="needs a CUDA card")
def test_tensor_parallel_on_the_card_at_1_2(tmp_path):
    """Reduced llama3-8b (4 KV heads, sharded with the query heads) and
    qwen3-14b with 1 KV head (which does not divide 2: k and v gathered,
    the decode cache sharded along its sequence) in float32 on (1, 2):
    the loss, every gradient, the forward's and 4 decode steps' logits
    and two train steps' losses within 1e-4 of the one-rank run; the
    flash-attention and RMSNorm kernels, forward and backward, launched
    on every rank."""
    spawn(card_rank, 2, tmp_path, str(tmp_path / "card_%d.json"))
    for r in range(2):
        res = json.loads((tmp_path / f"card_{r}.json").read_text())
        for arch, got in res.items():
            assert got["mesh"] == [1, 2], (arch, got)
            split = arch == "qwen3-14b"
            assert got["kv_gathered"] == got["cache_seq_sharded"] == split, \
                (arch, got)
            for k in ("loss", "grads", "logits", "decode"):
                assert got[k] <= TOL, (arch, k, got)
            assert max(got["losses"]) <= TOL, (arch, got)
            for k, (one, ranks) in got["launches"].items():
                assert one > 0 and ranks > 0, (arch, k, got["launches"])
