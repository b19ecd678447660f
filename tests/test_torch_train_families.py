"""Every family's reduced train step in the port against the JAX package.

The JAX package's float32 parameters (with AdamW's state) are carried
across by ``state_from_numpy``; the same numpy batch goes through both.
The port's loss and every gradient (through ``torch.autograd.grad`` over
the parameter leaves, the stacked layer axis taken a layer at a time)
agree with ``jax.value_and_grad(model.loss)`` within 1e-4, and its train
step's loss and grad_norm with the JAX package's; the remat policies
"none", "full" and "dots" leave the gradients as they are.  On the CPU
the kernels' dispatch runs their plain versions and plain backwards.
"""

import pytest

from torch_train_pair import check_gradients


@pytest.mark.parametrize("policy", ["none", "full", "dots"])
def test_dense_train_step_matches_jax(policy):
    check_gradients("qwen3-14b", policy)


@pytest.mark.parametrize("arch", [
    "internvl2-76b",         # vlm: the stub frontend's embeddings
    "nemotron-4-15b",        # squared ReLU through the overlay datapath
    "mixtral-8x22b",         # moe: slots, the spare row, a window
    "mamba2-370m",           # ssm: the chunked SSD and its segsum
    "zamba2-7b",             # hybrid: the shared block after its layers
    "whisper-large-v3",      # audio: encoder, cross-attention
])
def test_family_train_step_matches_jax(arch):
    check_gradients(arch, "full")


def test_moe_grouped_and_dots_train_step_matches_jax():
    check_gradients("qwen3-moe-235b-a22b", "dots", moe_grouped=True)
