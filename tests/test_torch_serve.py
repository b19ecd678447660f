"""The port's serving loop against the JAX package's raw serve loop.

Reduced qwen3-14b in float32, with the JAX parameters carried across by
``params_from_numpy``.  The JAX side runs the loop of
``repro.launch.serve._legacy_main`` (token-recurrent prefill and greedy
decode through ``make_serve_step``); the port's ``serve_loop`` is fed the
tokens JAX picked, and its logits after every step must equal JAX's at
1e-4 (the same operations, reductions in another order).
"""

import argparse
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as r_configs
from repro.models.registry import build_model as r_build_model
from repro.train.step import make_serve_step as r_make_serve_step
from repro_torch.configs import registry as configs
from repro_torch.launch import serve
from repro_torch.models.common import params_from_numpy
from repro_torch.models.registry import build_model

TOL = 1e-4
ARCH = "qwen3-14b"


@pytest.fixture(scope="module")
def models():
    r_cfg = dataclasses.replace(
        r_configs.reduced_config(r_configs.get_arch(ARCH)), dtype=jnp.float32)
    cfg = dataclasses.replace(configs.reduced_config(configs.get_arch(ARCH)),
                              dtype=torch.float32)
    r_model = r_build_model(r_cfg, remat_policy="none")
    r_params = r_model.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, r_params), cfg, "cpu")
    return r_model, r_params, build_model(cfg), params


def _jax_loop(r_model, r_params, prompt, gen):
    """``_legacy_main``'s loop without the mesh: → (tokens (B, gen),
    logits (P + gen, B, V))."""
    b, plen = prompt.shape
    cache = r_model.init_cache(b, plen + gen)
    step = jax.jit(r_make_serve_step(r_model))
    seen = []
    logits = None
    for i in range(plen):
        logits, cache = step(r_params, cache, jnp.asarray(prompt[:, i:i + 1]),
                             jnp.int32(i))
        seen.append(np.asarray(logits))
    out = []
    for i in range(gen):
        nxt = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        out.append(np.asarray(nxt))
        logits, cache = step(r_params, cache, nxt, jnp.int32(plen + i))
        seen.append(np.asarray(logits))
    return np.concatenate(out, axis=1), np.stack(seen)


def test_serve_loop_matches_the_jax_loop(models):
    r_model, r_params, model, params = models
    prompt = np.random.default_rng(0).integers(0, 256, (3, 6), np.int32)
    want_tokens, want_logits = _jax_loop(r_model, r_params, prompt, 6)

    forced = torch.from_numpy(want_tokens)
    res = serve.serve_loop(model, params, prompt, 6,
                           pick=lambda logits, i: forced[:, i])
    assert res.logits.shape == want_logits.shape == (12, 3, 256)
    np.testing.assert_allclose(res.logits.numpy(), want_logits, rtol=TOL,
                               atol=TOL)
    assert np.array_equal(res.tokens.numpy(), want_tokens)
    # greedy on its own logits picks what JAX picked
    greedy = serve.serve_loop(model, params, prompt, 6)
    assert np.array_equal(greedy.tokens.numpy(), want_tokens)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "qwen3-moe-235b-a22b",
                                  "mamba2-370m"])
def test_serve_loop_matches_the_jax_loop_for_moe_and_ssm(arch):
    """The same loop for the moe family (decode dispatches the batch as one
    group at the config's capacity factor, so tokens may drop, in both
    packages alike) and the ssm family (a conv window and a state in the
    cache, no KV)."""
    _family_loop_matches(arch)


@pytest.mark.parametrize("arch", ["zamba2-7b", "whisper-large-v3"])
def test_serve_loop_matches_the_jax_loop_for_hybrid_and_audio(arch):
    """The same loop for the hybrid family (Mamba's conv window and state
    and one KV cache per attention site) and the audio family (its decoder
    against the cross-attention KV of 1500 zero frames, as the JAX loop
    leaves it)."""
    _family_loop_matches(arch)


def _family_loop_matches(arch):
    r_cfg = dataclasses.replace(
        r_configs.reduced_config(r_configs.get_arch(arch)), dtype=jnp.float32)
    cfg = dataclasses.replace(configs.reduced_config(configs.get_arch(arch)),
                              dtype=torch.float32)
    r_model = r_build_model(r_cfg, remat_policy="none")
    r_params = jax.jit(r_model.init)(jax.random.PRNGKey(1))
    model = build_model(cfg)
    params = params_from_numpy(jax.tree.map(np.asarray, r_params), cfg, "cpu")
    prompt = np.random.default_rng(1).integers(0, 256, (3, 5), np.int32)
    want_tokens, want_logits = _jax_loop(r_model, r_params, prompt, 4)
    res = serve.serve_loop(model, params, prompt, 4)
    assert res.logits.shape == want_logits.shape == (9, 3, 256)
    np.testing.assert_allclose(res.logits.numpy(), want_logits, rtol=TOL,
                               atol=TOL)
    assert np.array_equal(res.tokens.numpy(), want_tokens)


def test_sampling_is_seeded_and_in_range(models):
    _, _, model, params = models
    prompt = np.zeros((2, 3), np.int32)
    runs = [serve.serve_loop(model, params, prompt, 5, pick=serve.sampler(
        1.5, torch.Generator().manual_seed(7))).tokens for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert runs[0].shape == (2, 5)
    assert int(runs[0].min()) >= 0 and int(runs[0].max()) < 256


def _args(**kw):
    base = dict(arch=ARCH, reduced=True, batch=2, prompt_len=3, gen=2,
                temperature=0.0, device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_legacy_main_runs_on_the_cpu_and_is_deterministic(temperature):
    outs = []
    for _ in range(2):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve._legacy_main(_args(temperature=temperature))
        outs.append(buf.getvalue())
    sample = [line for line in outs[0].splitlines()
              if line.startswith("sample:")]
    assert sample and sample == [line for line in outs[1].splitlines()
                                 if line.startswith("sample:")]
    assert "device=cpu" in outs[0]


def test_cli_without_a_card_or_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve._legacy_main(_args(device=None))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", ARCH, "--reduced", "--legacy"])


def test_overlay_serving_waits_for_the_runtime_slice(monkeypatch, capsys):
    """The serving layer on the runtime slice is ported: the default path
    serves through the Session, on the card unless asked for the CPU, and
    raises with no card (``tests/test_torch_serving.py`` holds it against
    the JAX package)."""
    stats = serve.serve_overlay(ARCH, n_requests=2, gen=1, slo="standard",
                                max_batch=2, device="cpu")
    assert stats["family"] == "transformer" and stats["completed"] == 2
    serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "2",
                "--gen", "1"])
    assert "completed=2" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", ARCH, "--reduced"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.serve_overlay(ARCH, n_requests=2, gen=1, slo="standard",
                            max_batch=2)
