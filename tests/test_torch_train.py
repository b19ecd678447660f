"""The port's training path around the train step, against the JAX package
where it has a counterpart: bfloat16 gradient accumulation, the train
loop's restart from a checkpoint mid-run, the training launcher on the CPU,
the state carried across by ``state_from_numpy``, and the places where
autograd could break silently (the overlay datapaths in compiled mode,
Mamba2's segment sums with their -inf).  Every family's gradients are in
``test_torch_train_families.py``.
"""

import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as r_mamba2
from repro.models import overlay_ops as r_overlay_ops
from repro.optim.adamw import AdamWConfig as RAdamWConfig
from repro.train.loop import TrainLoop as RTrainLoop
from repro.train.loop import TrainLoopConfig as RTrainLoopConfig
from repro.data.pipeline import SyntheticTokens as RSyntheticTokens
from repro.train.step import make_train_step as r_make_train_step
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch import train as launch_train
from repro_torch.models import mamba2, overlay_ops
from repro_torch.models.common import leaves, state_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import TrainLoop, TrainLoopConfig
from repro_torch.train.step import init_state, make_train_step
from torch_train_pair import F32_TOL, batch, pair

GRAD_TOL = 1e-5


def test_grad_accum_2_sums_in_bfloat16_as_the_reference_does():
    """Two microbatches, gradients summed in bfloat16 over float32
    parameters.  The loss agrees within 1e-4; the first moment after the
    step (0.1 x the clipped bfloat16 mean gradient) within one bfloat16
    rounding, since float32 gradients a hair apart can round to
    neighbouring bfloat16 values; grad_norm, a sum over those, within
    1e-3."""
    r_model, r_state, cfg, model, state = pair("llama3-8b", "none")
    b = batch(cfg, b=4)
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    r_new, r_m = jax.jit(r_make_train_step(r_model, RAdamWConfig(**opt),
                                           grad_accum=2))(
        r_state, jax.tree.map(jnp.asarray, b))
    new, m = make_train_step(model, AdamWConfig(**opt), grad_accum=2)(
        state, b)
    np.testing.assert_allclose(float(m["loss"]), float(r_m["loss"]),
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(r_m["grad_norm"]),
                               rtol=1e-3)
    for got, want in zip(leaves(new["opt"]["mu"]),
                         jax.tree.leaves(r_new["opt"]["mu"])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=2 ** -8,
                                   atol=2 ** -8 * float(np.abs(want).max()))
    # and not what a float32 sum gives: the mean of the two gradients
    _, m32 = make_train_step(model, AdamWConfig(**opt))(
        pair("llama3-8b", "none")[4], b)
    assert float(m["grad_norm"]) != float(m32["grad_norm"])


def _loop_cfg(**kw):
    return TrainLoopConfig(log_every=1, **kw)


def test_train_loop_resumes_from_a_checkpoint_mid_run(tmp_path):
    """A run cut after four steps and restarted from its checkpoint gives
    the uninterrupted run's last two steps and state, bit for bit; the
    uninterrupted run's losses follow the JAX package's loop."""
    r_model, r_state, cfg, model, _ = pair("qwen3-14b", "full")
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=6)
    step = make_train_step(model, AdamWConfig(**opt))

    def fresh():
        return pair("qwen3-14b", "full")[4]

    whole = TrainLoop(step, fresh(), SyntheticTokens(cfg.vocab, 16, 2),
                      _loop_cfg(total_steps=6))
    whole_out = whole.run()
    ckpt = str(tmp_path / "ckpt")
    first = TrainLoop(step, fresh(), SyntheticTokens(cfg.vocab, 16, 2),
                      _loop_cfg(total_steps=4, checkpoint_every=2,
                                checkpoint_dir=ckpt))
    assert first.run()["final_step"] == 4
    assert first.ckpt.available_steps() == [2, 4]
    second = TrainLoop(step, fresh(), SyntheticTokens(cfg.vocab, 16, 2),
                       _loop_cfg(total_steps=6, checkpoint_dir=ckpt))
    assert second.try_restore() and second.start_step == 4
    out = second.run()
    assert [m["step"] for m in out["metrics"]] == [4, 5]
    for got, want in zip(out["metrics"], whole_out["metrics"][4:]):
        assert (got["loss"], got["grad_norm"]) == (want["loss"],
                                                   want["grad_norm"])
    for a, b in zip(leaves(second.state), leaves(whole.state)):
        assert torch.equal(a, b)
    r_loop = RTrainLoop(jax.jit(r_make_train_step(r_model,
                                                  RAdamWConfig(**opt))),
                        r_state, RSyntheticTokens(cfg.vocab, 16, 2),
                        RTrainLoopConfig(total_steps=6, log_every=1))
    r_losses = [m["loss"] for m in r_loop.run()["metrics"]]
    np.testing.assert_allclose([m["loss"] for m in whole_out["metrics"]],
                               r_losses, rtol=1e-3)


def test_train_loop_writes_no_checkpoint_of_a_step_that_raised(tmp_path):
    """A step that raises partway through AdamW's in-place update leaves
    the state half updated: the loop writes no checkpoint of it on its way
    out, and a restart resumes from the last whole step's checkpoint."""
    from repro_torch.optim import adamw
    _, _, cfg, model, _ = pair("qwen3-14b", "none")
    step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=2,
                                              total_steps=6))

    def fresh():
        return pair("qwen3-14b", "none")[4]

    ckpt = str(tmp_path / "ckpt")
    loop = TrainLoop(step, fresh(), SyntheticTokens(cfg.vocab, 16, 2),
                     _loop_cfg(total_steps=6, checkpoint_every=2,
                               checkpoint_dir=ckpt))
    real, calls = adamw._update, []

    def fails_at_step_3(*args):
        calls.append(None)
        n = len(leaves(loop.state["params"]))
        if len(calls) > 3 * n + n // 2:     # halfway through step 3's leaves
            raise RuntimeError("out of memory")
        return real(*args)

    with mock.patch.object(adamw, "_update", fails_at_step_3):
        with pytest.raises(RuntimeError, match="out of memory"):
            loop.run()
    assert loop.ckpt.available_steps() == [2]
    # the checkpoint of step 2 holds the state after steps 0, 1 and 2
    done = TrainLoop(step, fresh(), SyntheticTokens(cfg.vocab, 16, 2),
                     _loop_cfg(total_steps=3))
    done.run()
    torn = [torch.equal(a, b) for a, b in zip(leaves(loop.state["params"]),
                                              leaves(done.state["params"]))]
    assert any(torn) and not all(torn)      # step 3 stopped halfway
    again = TrainLoop(step, fresh(), SyntheticTokens(cfg.vocab, 16, 2),
                      _loop_cfg(total_steps=6, checkpoint_dir=ckpt))
    assert again.try_restore() and again.start_step == 2
    for a, b in zip(leaves(again.state), leaves(done.state)):
        assert torch.equal(a, b)


def test_launch_train_runs_and_resumes_on_the_cpu(tmp_path, capsys):
    args = ["--arch", "qwen3-14b", "--reduced", "--batch", "2", "--seq",
            "16", "--ckpt", str(tmp_path / "ckpt"), "--remat", "dots"]
    out = launch_train.main(args + ["--steps", "3", "--metrics-out",
                                    str(tmp_path / "m.json")],
                            device="cpu")
    # logged every tenth step and at the last, as the reference logs
    assert out["final_step"] == 3
    assert [m["step"] for m in out["metrics"]] == [0, 2]
    assert json.loads((tmp_path / "m.json").read_text())["final_step"] == 3
    assert "resumed=False start=0" in capsys.readouterr().out
    out = launch_train.main(args + ["--steps", "5"], device="cpu")
    assert out["final_step"] == 5
    assert [m["step"] for m in out["metrics"]] == [4]
    assert "resumed=True start=3" in capsys.readouterr().out
    # one rank: --model-shards shrinks to a (1, 1) mesh, as the reference's
    # host mesh does on one device; the production mesh needs 256 ranks
    out = launch_train.main(args + ["--steps", "6", "--model-shards", "2"],
                            device="cpu")
    assert out["final_step"] == 6
    assert "mesh={'data': 1, 'model': 1}" in capsys.readouterr().out
    with pytest.raises(ValueError, match="needs 256 ranks"):
        launch_train.main(args + ["--production-mesh"], device="cpu")


def test_launch_train_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "yi-6b", "--reduced", "--steps", "1"])


def test_state_from_numpy_carries_the_state_bit_for_bit():
    _, r_state, cfg, _, state = pair("mamba2-370m", "none")
    for got, want in zip(leaves(state), jax.tree.leaves(r_state)):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
    assert state["opt"]["step"].dtype == torch.int32
    bad = jax.tree.map(np.asarray, r_state)
    bad["opt"]["mu"]["lm"]["embed"] = bad["opt"]["mu"]["lm"]["embed"] \
        .astype(np.float16)
    with pytest.raises(ValueError, match="moments are float32"):
        state_from_numpy(bad, cfg, "cpu")


def test_remat_policies_are_checked():
    _, _, cfg, _, _ = pair("qwen3-14b", "none")
    with pytest.raises(ValueError, match="remat policy 'most'"):
        build_model(cfg, remat_policy="most")
    whisper = build_model(pair("whisper-large-v3", "none")[2],
                          remat_policy="dots")
    assert whisper.remat_policy == "dots" and whisper._remat == "full"


def test_remat_recomputes_the_forward_in_the_backward(monkeypatch):
    """"full" runs each layer's forward again in the backward, "none"
    does not: the attention's forward is called twice as often."""
    from repro_torch.models import layers
    calls = []
    real = layers.fa_ops.attention

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(layers.fa_ops, "attention", counted)
    for policy, want in (("none", 2), ("full", 4), ("dots", 4)):
        _, _, cfg, model, state = pair("qwen3-14b", policy)
        calls.clear()
        init = init_state(model, torch.Generator().manual_seed(0))
        make_train_step(model, AdamWConfig())(init, batch(cfg))
        assert len(calls) == want * cfg.n_layers // 2, policy


@pytest.mark.parametrize("name", ["gated_silu", "squared_relu"])
def test_overlay_datapaths_carry_gradients(name):
    """The overlay kernels run in compiled mode (the routed DFG evaluated
    as torch ops): their gradients equal ``jax.vjp`` of the JAX
    package's."""
    rng = np.random.default_rng(0)
    args = [rng.standard_normal((3, 17)).astype(np.float32)
            for _ in range(2 if name == "gated_silu" else 1)]
    g = rng.standard_normal((3, 17)).astype(np.float32)
    out, vjp = jax.vjp(getattr(r_overlay_ops, name),
                       *map(jnp.asarray, args))
    want = vjp(jnp.asarray(g))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    got = getattr(overlay_ops, name)(*ts)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    got.backward(torch.tensor(g))
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


def test_segsum_gradient_is_finite_as_jax_grad_is():
    """The -inf above the diagonal goes in after the subtraction, so the
    gradient through exp() of it is finite, and equals ``jax.grad``'s."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((2, 3, 8)).astype(np.float32) * 0.3
    w = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
    want = jax.grad(lambda x: jnp.sum(jnp.exp(r_mamba2._segsum(x)) * w))(
        jnp.asarray(a))
    at = torch.tensor(a, requires_grad=True)
    (torch.exp(mamba2._segsum(at)) * torch.tensor(w)).sum().backward()
    assert bool(torch.isfinite(at.grad).all())
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(want),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
