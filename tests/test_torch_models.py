"""The port's dense model path against the JAX package.

For the reduced configs of the dense family (yi-6b, llama3-8b, qwen3-14b,
nemotron-4-15b with squared ReLU) and the vlm family (internvl2-76b, with
``input_embeds``), the JAX package's parameters are carried across with
``params_from_numpy`` and the same token ids (numpy, from a seed) go through
both.  In float32 the tolerance is 1e-4: the two run the same operations and
differ only in the order of reductions.  The one bfloat16 leg allows 5e-2,
because XLA and torch round bfloat16 intermediates at different places.  On
the CPU every kernel call takes its plain version.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as r_configs
from repro.models import layers as r_layers
from repro.models import overlay_ops as r_overlay_ops
from repro.models.registry import build_model as r_build_model
from repro.train.step import make_prefill_step as r_make_prefill_step
from repro_torch.configs import registry as configs
from repro_torch.models import layers, overlay_ops
from repro_torch.models.common import array_to_tensor, params_from_numpy
from repro_torch.models.registry import build_model, get_config
from repro_torch.train.step import make_prefill_step

ARCHS = ["yi-6b", "llama3-8b", "qwen3-14b", "nemotron-4-15b", "internvl2-76b"]
F32_TOL = 1e-4
BF16_TOL = 5e-2
KEY = jax.random.PRNGKey(0)

# JAX model init is the slow part: build each (arch, dtype) pair once; the
# tests only read the parameters
_CACHE = {}


def _pair(arch, dtype="float32", **kw):
    key = (arch, dtype, tuple(sorted(kw.items())))
    if key not in _CACHE:
        r_cfg = dataclasses.replace(
            r_configs.reduced_config(r_configs.ALL_ARCHS[arch]),
            dtype=getattr(jnp, dtype))
        cfg = dataclasses.replace(
            configs.reduced_config(configs.ALL_ARCHS[arch]),
            dtype=getattr(torch, dtype))
        r_model = r_build_model(r_cfg, remat_policy="none", **kw)
        r_params = r_model.init(KEY)
        params = params_from_numpy(jax.tree.map(np.asarray, r_params), cfg,
                                   "cpu")
        _CACHE[key] = (r_cfg, r_model, r_params, cfg, build_model(cfg, **kw),
                       params)
    return _CACHE[key]


def _batch(cfg, b=2, s=12, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    emb = None
    if cfg.frontend == "vision":
        emb = rng.standard_normal((b, max(1, s // 8), cfg.d_model)
                                  ).astype(np.float32)
    return toks, emb


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", sorted(configs.ALL_ARCHS))
def test_configs_match_the_reference(arch):
    mine, theirs = configs.ALL_ARCHS[arch], r_configs.ALL_ARCHS[arch]
    for cfg, r_cfg in ((mine, theirs),
                       (configs.reduced_config(mine),
                        r_configs.reduced_config(theirs))):
        a, b = dataclasses.asdict(cfg), dataclasses.asdict(r_cfg)
        assert str(a.pop("dtype")).split(".")[-1] == \
            jnp.dtype(b.pop("dtype")).name
        assert a == b
        assert cfg.param_count() == r_cfg.param_count()
        assert cfg.active_param_count() == r_cfg.active_param_count()
        assert cfg.vocab_padded == r_cfg.vocab_padded
    assert configs.SHAPES == r_configs.SHAPES
    for shape in configs.SHAPES:
        assert configs.shape_applicable(mine, shape) == \
            r_configs.shape_applicable(theirs, shape)
    assert get_config(arch) is mine


@pytest.mark.parametrize("arch", ARCHS)
def test_init_layout_matches_the_reference(arch):
    r_cfg, _, r_params, cfg, model, _ = _pair(arch)
    params = model.init(torch.Generator().manual_seed(0))
    mine = {"/".join(str(k.key) for k in path): (tuple(leaf.shape),)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                jax.tree.map(lambda t: np.zeros(t.shape), params))[0]}
    theirs = {"/".join(str(k.key) for k in path): (tuple(leaf.shape),)
              for path, leaf in jax.tree_util.tree_flatten_with_path(
                  r_params)[0]}
    assert mine == theirs
    assert all(t.dtype == cfg.dtype for t in jax.tree.leaves(
        params, is_leaf=lambda x: isinstance(x, torch.Tensor)))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_decode_and_prefill_match_jax(arch):
    r_cfg, r_model, r_params, cfg, model, params = _pair(arch)
    toks, emb = _batch(cfg)
    j_emb = None if emb is None else jnp.asarray(emb)
    t_emb = None if emb is None else torch.from_numpy(emb)

    want = r_model.forward_train(r_params, jnp.asarray(toks), j_emb)
    got = model.forward_train(params, torch.from_numpy(toks), t_emb)
    assert got.shape == (2, 12, cfg.vocab_padded)
    _close(got, want, F32_TOL)

    want = r_make_prefill_step(r_model)(
        r_params, {"tokens": jnp.asarray(toks), "input_embeds": j_emb})
    got = make_prefill_step(model)(
        params, {"tokens": torch.from_numpy(toks), "input_embeds": t_emb})
    assert got.shape == (2, cfg.vocab_padded)
    _close(got, want, F32_TOL)

    # 12 decode steps, each against the JAX step on the same cache state
    r_cache = r_model.init_cache(2, 12, dtype=jnp.float32)
    cache = model.init_cache(2, 12, dtype=torch.float32)
    for i in range(12):
        r_logits, r_cache = r_model.forward_decode(
            r_params, r_cache, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        logits, cache = model.forward_decode(
            params, cache, torch.from_numpy(toks[:, i:i + 1]), i)
        assert logits.shape == (2, 1, cfg.vocab_padded)
        _close(logits, r_logits, F32_TOL)
    _close(cache["k"], r_cache["k"], F32_TOL)
    _close(cache["v"], r_cache["v"], F32_TOL)


def test_bfloat16_forward_and_decode_match_jax():
    r_cfg, r_model, r_params, cfg, model, params = _pair("qwen3-14b",
                                                         "bfloat16")
    toks, _ = _batch(cfg, seed=1)
    _close(model.forward_train(params, torch.from_numpy(toks)),
           r_model.forward_train(r_params, jnp.asarray(toks)), BF16_TOL)
    r_cache = r_model.init_cache(2, 4)
    cache = model.init_cache(2, 4)
    for i in range(4):
        r_logits, r_cache = r_model.forward_decode(
            r_params, r_cache, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        logits, cache = model.forward_decode(
            params, cache, torch.from_numpy(toks[:, i:i + 1]), i)
        _close(logits, r_logits, BF16_TOL)


def test_parallel_block_and_loss_match_jax():
    r_cfg, r_model, r_params, cfg, model, params = _pair(
        "llama3-8b", parallel_block=True)
    toks, _ = _batch(cfg, seed=2)
    _close(model.forward_train(params, torch.from_numpy(toks)),
           r_model.forward_train(r_params, jnp.asarray(toks)), F32_TOL)
    labels = np.roll(toks, -1, axis=1)
    want = r_model.loss(r_params, {"tokens": jnp.asarray(toks),
                                   "labels": jnp.asarray(labels)})
    got = model.loss(params, {"tokens": torch.from_numpy(toks),
                              "labels": torch.from_numpy(labels)})
    assert abs(float(got) - float(want)) <= F32_TOL


def test_carry_over_takes_a_jax_bfloat16_array_exactly():
    x = jax.random.normal(KEY, (64, 33), jnp.bfloat16) * 1e3
    x = x.at[0, :4].set(jnp.array([jnp.inf, -jnp.inf, 0.0, -0.0],
                                  jnp.bfloat16))
    a = np.asarray(x)
    assert a.dtype.name == "bfloat16"
    t = array_to_tensor(a)
    assert t.dtype == torch.bfloat16 and t.shape == (64, 33)
    assert np.array_equal(t.view(torch.int16).numpy(), a.view(np.int16))
    cfg = dataclasses.replace(configs.get_arch("qwen3-14b"))
    tree = params_from_numpy({"lm": {"embed": a}}, cfg)
    assert torch.equal(tree["lm"]["embed"].view(torch.int16),
                       t.view(torch.int16))
    with pytest.raises(ValueError, match="config says"):
        params_from_numpy({"w": np.zeros(3, np.float32)}, cfg)


@pytest.mark.parametrize("arch", ["zamba2-7b", "whisper-large-v3"])
def test_unported_families_raise(arch):
    with pytest.raises(NotImplementedError, match="model-families slice"):
        build_model(configs.get_arch(arch))


@pytest.mark.parametrize("pos_shape", [(7,), (2, 7)])
def test_rope_matches_jax(pos_shape):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 7, 16)).astype(np.float32)
    pos = rng.integers(0, 4096, pos_shape)
    want = r_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    _close(got, want, F32_TOL)


def test_overlay_ops_match_jax():
    rng = np.random.default_rng(4)
    a, b = (rng.standard_normal((3, 50)).astype(np.float32) for _ in "ab")
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for name in ("gated_silu", "ssm_gate", "residual_add"):
        got = getattr(overlay_ops, name)(ta, tb)
        _close(got, getattr(r_overlay_ops, name)(ja, jb), 1e-6)
    _close(overlay_ops.squared_relu(ta), r_overlay_ops.squared_relu(ja),
           1e-6)
    assert set(overlay_ops.compiled_kernels()) == set(overlay_ops.KERNELS)
    assert overlay_ops.gated_silu(ta.to(torch.bfloat16),
                                  tb.to(torch.bfloat16)).dtype == \
        torch.bfloat16


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 5, 40)).astype(np.float32) * 3
    labels = rng.integers(0, 40, (2, 5)).astype(np.int32)
    want = r_layers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = layers.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels))
    assert abs(float(got) - float(want)) <= 1e-5
