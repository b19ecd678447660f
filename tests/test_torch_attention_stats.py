"""The row statistics the forward attention kernels write for the backward,
and the backward that reads them, against the JAX package.

``ref.attention_stats`` gives each row's max m of the scaled, masked logits
and the sum l of exp(S - m), the meaning both forward kernels' ``stats``
output has; here it is held against m and l computed with ``jax.numpy``
from the logits and mask of ``repro/kernels/flash_attention/ref.py`` (the
JAX package keeps no statistics of its own), at 1e-5 in float32.
``ref.attention_bwd(..., stats=)`` gives the same gradients as without
them and as ``jax.vjp`` of the JAX attention.  The CPU route of the
autograd Function keeps the statistics and its backward reads them.  On a
card, ``tests/test_torch_flash_attention.py`` holds each forward kernel's
statistics against ``ref.attention_stats``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ref as r_ref
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.flash_attention import ref

STATS_TOL = 1e-5
GRAD_TOL = 1e-5        # test_torch_kernel_grad.py's, against jax.vjp

# chip_smoke.py's FA_BWD_CASES cut to a few heads and at most 300 rows:
# (b, hq, hkv, sq, skv, d, causal, window)
STATS_CASES = [
    (1, 10, 2, 256, 256, 64, True, None),     # GQA group 5 (qwen3-14b's)
    (1, 4, 2, 256, 256, 32, True, 32),        # window
    (1, 6, 2, 130, 70, 64, True, None),       # Sq > Skv: rows see no key
    (2, 4, 4, 100, 300, 64, False, None),     # Sq < Skv, not causal
    (1, 8, 2, 200, 280, 32, True, 64),        # window, Sq < Skv
]

# test_torch_kernel_grad.py's ATTN_CASES: every mask case of the forward
ATTN_CASES = [
    (2, 4, 2, 9, 9, 32, True, None),
    (1, 4, 4, 9, 9, 16, False, None),
    (1, 8, 2, 20, 20, 16, True, 5),
    (1, 4, 2, 12, 30, 16, False, 7),
    (2, 4, 2, 7, 19, 32, True, None),
    (1, 6, 2, 13, 5, 16, True, None),
    (1, 4, 1, 11, 4, 16, True, 2),
]


def _arrays(b, hq, hkv, sq, skv, d, seed):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((b, hq, sq, d)).astype(np.float32)
             for _ in "qg")
    k, v = (rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
            for _ in "kv")
    return q, k, v, do


def jax_stats(q, k, *, causal, window):
    """m and l from the logits and mask of ``repro``'s ref.attention,
    restated in jnp line for line (the function returns only its output)."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    qf = (jnp.asarray(q) * d ** -0.5).reshape(b, hkv, hq // hkv, sq, d)
    logits = jnp.einsum("bhgqd,bhkd->bhgqk", qf, jnp.asarray(k))
    q_pos = jnp.arange(sq)[:, None] + (skv - sq)
    k_pos = jnp.arange(skv)[None, :]
    mask = jnp.ones((sq, skv), bool)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    logits = jnp.where(mask[None, None, None], logits, -1e30)
    m = logits.max(axis=-1, keepdims=True)
    l = jnp.exp(logits - m).sum(axis=-1)
    return (np.asarray(m).reshape(b, hq, sq), np.asarray(l).reshape(b, hq, sq))


@pytest.mark.parametrize("case", STATS_CASES, ids=str)
def test_attention_stats_match_jax(case):
    b, hq, hkv, sq, skv, d, causal, window = case
    q, k, v, _ = _arrays(b, hq, hkv, sq, skv, d, seed=11)
    m, l = ref.attention_stats(*map(torch.from_numpy, (q, k, v)),
                               causal=causal, window=window)
    assert m.shape == l.shape == (b, hq, sq)
    assert m.dtype == l.dtype == torch.float32
    want_m, want_l = jax_stats(q, k, causal=causal, window=window)
    np.testing.assert_allclose(m.numpy(), want_m, rtol=STATS_TOL,
                               atol=STATS_TOL)
    np.testing.assert_allclose(l.numpy(), want_l, rtol=STATS_TOL,
                               atol=STATS_TOL)
    # the statistics are the softmax's: exp(S - m) / l sums to 1 by row,
    # and the JAX attention is that softmax applied to v
    out = r_ref.attention(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(
        ref.attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                      window=window).numpy(), np.asarray(out),
        rtol=2e-3, atol=2e-3)


def test_rows_that_see_no_key_keep_m_and_l_apart():
    """Sq > Skv, causal: a row before the first key has m = -1e30 exactly
    and l = Skv (every masked logit gives exp(0)); m + log l would round
    to m."""
    q, k, v, _ = _arrays(1, 2, 1, 9, 4, 16, seed=12)
    m, l = ref.attention_stats(*map(torch.from_numpy, (q, k, v)))
    assert bool((m[:, :, :5] == ref.NEG_INF).all())
    assert bool((l[:, :, :5] == 4).all())
    assert bool((m[:, :, 5:] > -1e3).all()) and bool((l[:, :, 5:] >= 1).all())


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_attention_bwd_with_stats_matches_without_and_jax_vjp(case):
    b, hq, hkv, sq, skv, d, causal, window = case
    q, k, v, do = _arrays(b, hq, hkv, sq, skv, d, seed=6)
    kw = dict(causal=causal, window=window)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o = ref.attention(tq, tk, tv, **kw)
    stats = torch.stack(ref.attention_stats(tq, tk, tv, **kw))
    got = ref.attention_bwd(tq, tk, tv, o, tdo, stats=stats, **kw)
    plain = ref.attention_bwd(tq, tk, tv, o, tdo, **kw)
    _, vjp = jax.vjp(lambda a, c, e: r_ref.attention(a, c, e, **kw),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    for g, p_, w in zip(got, plain, want):
        assert torch.equal(g, p_)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


def test_cpu_function_saves_the_stats_and_its_backward_reads_them(
        monkeypatch):
    q, k, v, do = (torch.from_numpy(a) for a in
                   _arrays(1, 4, 2, 13, 5, 16, seed=13))
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*ts, window=3)
    saved = out.grad_fn.saved_tensors
    stats = torch.stack(ref.attention_stats(q, k, v, window=3))
    assert len(saved) == 5 and torch.equal(saved[4], stats)
    seen = []
    real = ref.attention_bwd

    def spy(*args, **kw):
        seen.append(kw.get("stats"))
        return real(*args, **kw)
    monkeypatch.setattr(fa.ref, "attention_bwd", spy)
    out.backward(do)
    assert len(seen) == 1 and seen[0] is not None
    assert torch.equal(seen[0], stats)
    want = real(q, k, v, out.detach(), do, window=3)
    for t, w in zip(ts, want):
        assert torch.equal(t.grad, w)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 112, "wgmma"),
    (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 16, "simt"), (torch.bfloat16, 32, "simt"),
    (torch.float32, 16, "simt"), (torch.float32, 32, "simt"),
    (torch.float32, 64, "simt"), (torch.float32, 112, "simt"),
    (torch.float32, 128, "simt")])
def test_backward_route_is_the_forwards(dtype, d, want):
    """The backward takes its forward's route: the tensor-core backward
    for bfloat16 at D 64, 112 and 128, the SIMT one otherwise."""
    assert fa.route(dtype, d) == want
    lib = fa.BWD_LIBRARIES[fa.route(dtype, d)]
    assert lib.source.name == {
        "wgmma": "flash_attention_bwd_wgmma.cu",
        "simt": "flash_attention_bwd.cu"}[want]
    assert fa.LIBRARIES[want].source.name == {
        "wgmma": "flash_attention_wgmma.cu",
        "simt": "flash_attention.cu"}[want]


@pytest.mark.parametrize("bad", ["shape", "old layout", "dtype", "strided",
                                 "device"])
def test_backward_refuses_stats_of_the_wrong_shape_or_dtype(bad):
    q = torch.ones(1, 4, 6, 16)
    k = torch.ones(1, 2, 6, 16)
    good = torch.ones(2, 1, 4, 6)
    stats = {"shape": torch.ones(2, 1, 4, 5),
             "old layout": torch.ones(3, 1, 4, 6),
             "dtype": good.double(),
             "strided": torch.ones(1, 4, 6, 2).permute(3, 0, 1, 2),
             "device": good.to("meta")}[bad]
    with pytest.raises(ValueError, match="stats must be float32"):
        fa.flash_attention_bwd(q, k, k, q, q, stats=stats)
    fa.flash_attention_bwd(q, k, k, q, q, stats=good)     # the right one


def test_backward_launch_refuses_other_routes_and_faults():
    q, stats = torch.ones(1, 2, 4, 16), torch.ones(2, 1, 2, 4)
    with pytest.raises(ValueError, match="unknown flash-attention route"):
        fa._launch_bwd(q, q, q, q, q, stats, route="pallas")
    with pytest.raises(ValueError, match="no planted fault 3 in the simt"):
        fa._launch_bwd(q, q, q, q, q, stats, route="simt", fault=3)
    with pytest.raises(ValueError, match="bfloat16 at head dims"):
        fa._launch_bwd(q, q, q, q, q, stats, route="wgmma")
