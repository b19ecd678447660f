"""The port's AdamW, its schedule and clipping, and the synthetic token
pipeline, against the JAX package on the same numpy inputs.

Given identical gradients, the update agrees within 1e-6 in float32: both
run the same elementwise formula and differ only in the order of the
global norm's sums.  A bfloat16 parameter may land one bfloat16 rounding
away where the float32 result sits at a rounding boundary.  The token
batches are equal bit for bit (the same numpy Philox stream).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as r_pipeline
from repro.optim import adamw as r_adamw
from repro_torch.data import pipeline
from repro_torch.models.common import array_to_tensor, leaves, tree_map
from repro_torch.optim import adamw

TOL = 1e-6


def _tree(rng, dtype=np.float32):
    """A nested parameter-like tree, keys out of sorted order on purpose."""
    return {"w": rng.standard_normal((7, 5)).astype(dtype),
            "a": {"z": rng.standard_normal(11).astype(dtype),
                  "b": rng.standard_normal((2, 3, 4)).astype(dtype)}}


def _torch(tree):
    return tree_map(lambda a: array_to_tensor(np.asarray(a)), tree)


def _close(got, want, tol=TOL):
    for g, w in zip(leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("cfg", [
    dict(), dict(warmup_steps=3, total_steps=10, lr=1e-2),
    dict(warmup_steps=1, total_steps=1), dict(warmup_steps=50,
                                              total_steps=40)])
def test_lr_schedule_matches_the_reference(cfg):
    mine, theirs = adamw.AdamWConfig(**cfg), r_adamw.AdamWConfig(**cfg)
    for step in (0, 1, 2, 3, 7, 39, 40, 99, 100, 5000, 10_000, 20_000):
        got = adamw.lr_schedule(mine, torch.tensor(step, dtype=torch.int32))
        want = r_adamw.lr_schedule(theirs, jnp.int32(step))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=TOL)


def test_adamw_init_mirrors_the_parameters():
    params = _torch(_tree(np.random.default_rng(0)))
    params["a"]["b"] = params["a"]["b"].to(torch.bfloat16)
    state = adamw.adamw_init(params)
    want = r_adamw.adamw_init(jax.tree.map(jnp.asarray,
                                           _tree(np.random.default_rng(0))))
    for got, ref in zip(leaves(state["mu"]) + leaves(state["nu"]),
                        jax.tree.leaves(want["mu"])
                        + jax.tree.leaves(want["nu"])):
        assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
        assert not got.any()
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_the_reference(max_norm):
    grads = _tree(np.random.default_rng(1))
    got, gn = adamw.clip_by_global_norm(_torch(grads), max_norm)
    want, r_gn = r_adamw.clip_by_global_norm(
        jax.tree.map(jnp.asarray, grads), max_norm)
    np.testing.assert_allclose(float(gn), float(r_gn), rtol=TOL)
    _close(got, want)
    assert all(g.dtype == torch.float32 for g in leaves(got))


def _mid_schedule_state(rng, params):
    """Moments and a step as a run would hold them a few steps in."""
    return {"mu": tree_map(lambda p: 0.1 * rng.standard_normal(
                p.shape).astype(np.float32), params),
            "nu": tree_map(lambda p: 0.01 * rng.random(p.shape).astype(
                np.float32), params),
            "step": np.int32(4)}


@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_update_given_identical_gradients(clip):
    rng = np.random.default_rng(2)
    params, grads = _tree(rng), _tree(rng)
    st = _mid_schedule_state(rng, params)
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=20, clip_norm=clip)
    mine, opt = _torch(params), _torch(st)
    for step in range(3):
        g = tree_map(lambda a: a * (step + 1), grads)
        mine, opt, m = adamw.adamw_update(adamw.AdamWConfig(**cfg), mine,
                                          _torch(g), opt)
        params, st, rm = r_adamw.adamw_update(
            r_adamw.AdamWConfig(**cfg), jax.tree.map(jnp.asarray, params),
            jax.tree.map(jnp.asarray, g), st)
        _close(mine, params)
        _close(opt["mu"], st["mu"])
        _close(opt["nu"], st["nu"])
        assert int(opt["step"]) == int(st["step"]) == 5 + step
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=TOL)


def test_adamw_update_of_bfloat16_parameters():
    """bfloat16 parameters, float32 moments: each updated parameter is
    the reference's or one bfloat16 rounding from it."""
    import ml_dtypes
    rng = np.random.default_rng(3)
    params = _tree(rng, ml_dtypes.bfloat16)
    grads = _tree(rng, ml_dtypes.bfloat16)
    st = _mid_schedule_state(rng, params)
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    mine, opt, _ = adamw.adamw_update(cfg, _torch(params), _torch(grads),
                                      _torch(st))
    want, r_st, _ = r_adamw.adamw_update(
        r_adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10),
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, grads),
        st)
    for g, w in zip(leaves(mine), jax.tree.leaves(want)):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.float().numpy(), w, rtol=2 ** -7,
                                   atol=1e-6)
    _close(opt["mu"], r_st["mu"])
    _close(opt["nu"], r_st["nu"])


def test_adamw_update_is_in_place_and_sliced_alike(monkeypatch):
    """The same tensors come back, updated; slices of a leaf give the
    whole leaf's update (to the rounding of the norm's regrouped sums)."""
    rng = np.random.default_rng(4)
    params, grads = _tree(rng), _tree(rng)
    st = _mid_schedule_state(rng, params)
    cfg = adamw.AdamWConfig(lr=1e-2)
    whole_p, whole_s = _torch(params), _torch(st)
    ids = [id(t) for t in leaves(whole_p) + leaves(whole_s["mu"])]
    new_p, new_s, _ = adamw.adamw_update(cfg, whole_p, _torch(grads),
                                         whole_s)
    assert [id(t) for t in leaves(new_p) + leaves(new_s["mu"])] == ids
    monkeypatch.setattr(adamw, "SLICE", 4)          # many slices a leaf
    sliced_p, sliced_s, _ = adamw.adamw_update(cfg, _torch(params),
                                               _torch(grads), _torch(st))
    for a, b in zip(leaves(new_p) + leaves(new_s),
                    leaves(sliced_p) + leaves(sliced_s)):
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 123456)])
def test_synthetic_tokens_equal_the_reference(seed, step):
    got = pipeline.SyntheticTokens(50000, 33, 3, seed=seed).batch_at(step)
    want = r_pipeline.SyntheticTokens(50000, 33, 3, seed=seed).batch_at(step)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_batch_iterator_starts_at_the_step_and_adds_the_extra():
    ds = pipeline.SyntheticTokens(100, 8, 2)
    extra = {"input_embeds": np.zeros((2, 1, 4), np.float32)}
    it = pipeline.make_batch_iterator(ds, start_step=5, extra=extra)
    r_it = r_pipeline.make_batch_iterator(r_pipeline.SyntheticTokens(100, 8,
                                                                     2),
                                          start_step=5, extra=extra)
    try:
        for want_step in (5, 6, 7):
            (step, batch), (r_step, r_batch) = next(it), next(r_it)
            assert step == r_step == want_step
            assert isinstance(batch["tokens"], np.ndarray)
            for k in r_batch:
                np.testing.assert_array_equal(batch[k], r_batch[k])
    finally:
        it.close()
        r_it.close()
