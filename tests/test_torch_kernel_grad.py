"""Gradients through flash attention and RMSNorm, every route.

Each wrapper is a ``torch.autograd.Function`` whose forward and backward
the device picks: on the card the CUDA kernels (``csrc/rmsnorm.cu``'s
backward, ``csrc/flash_attention_bwd.cu``), on the CPU the plain versions
``ref.rmsnorm_bwd`` and ``ref.attention_bwd``.  The JAX package trains
through its plain jnp versions and has no backward kernel, so the plain
backwards are held against ``jax.vjp`` of the JAX plain versions (float32,
1e-5) over every mask case the forwards take, rows that see no key
included; the plain route (``impl="ref"``, differentiated by autograd)
gives the same gradients as ``jax.grad``.  On the card the kernels'
gradients equal the plain route's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ref as r_attn
from repro.kernels.rmsnorm import ref as r_rms
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.flash_attention import ref as attn_ref
from repro_torch.kernels.rmsnorm import kernel as rms
from repro_torch.kernels.rmsnorm import ref as rms_ref

GRAD_TOL = 1e-5


def gpu(fn):
    """Needs a CUDA card: decided when the test runs, not at import."""
    fn = pytest.mark.skipif("not torch.cuda.is_available()",
                            reason="needs a CUDA card")(fn)
    return pytest.mark.gpu(fn)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    q = rng.standard_normal((2, 4, 9, 32)).astype(np.float32)
    k = rng.standard_normal((2, 2, 11, 32)).astype(np.float32)
    v = rng.standard_normal((2, 2, 11, 32)).astype(np.float32)
    g = rng.standard_normal((2, 4, 9, 32)).astype(np.float32)
    return x, w, q, k, v, g


def _close(got, want, tol=GRAD_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("impl", [None, "ref"])
def test_plain_rmsnorm_route_gives_the_reference_gradients(impl):
    x, w, *_ = _inputs()
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    out = rms.rmsnorm(xt, wt, impl=impl)
    (out * out).sum().backward()
    gx, gw = jax.grad(lambda a, b: jnp.sum(r_rms.rmsnorm(a, b) ** 2),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    _close(xt.grad.numpy(), gx)
    _close(wt.grad.numpy(), gw)


@pytest.mark.parametrize("impl", [None, "ref"])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 4)])
def test_plain_attention_route_gives_the_reference_gradients(impl, causal,
                                                             window):
    _, _, q, k, v, g = _inputs(1)
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = fa.flash_attention(*ts, causal=causal, window=window, impl=impl)
    (out * torch.tensor(g)).sum().backward()

    def loss(a, b, c):
        return jnp.sum(r_attn.attention(a, b, c, causal=causal,
                                        window=window) * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for t, w in zip(ts, want):
        _close(t.grad.numpy(), w)


@pytest.mark.parametrize("shape,eps", [((3, 5, 64), 1e-6), ((7, 37), 1e-5),
                                       ((2, 1, 4, 128), 1e-6)])
def test_rmsnorm_bwd_matches_jax_vjp(shape, eps):
    rng = np.random.default_rng(5)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: r_rms.rmsnorm(a, b, eps=eps),
                     jnp.asarray(x), jnp.asarray(w))
    want_x, want_w = vjp(jnp.asarray(dy))
    got_x, got_w = rms_ref.rmsnorm_bwd(torch.tensor(x), torch.tensor(w),
                                       torch.tensor(dy), eps=eps)
    _close(got_x.numpy(), want_x)
    _close(got_w.numpy(), want_w)


# (b, hq, hkv, sq, skv, d, causal, window): every mask case of the forward
ATTN_CASES = [
    (2, 4, 2, 9, 9, 32, True, None),       # causal, group 2
    (1, 4, 4, 9, 9, 16, False, None),      # not causal, group 1
    (1, 8, 2, 20, 20, 16, True, 5),        # causal window, group 4
    (1, 4, 2, 12, 30, 16, False, 7),       # window, not causal, Sq < Skv
    (2, 4, 2, 7, 19, 32, True, None),      # Sq < Skv, end-aligned
    (1, 6, 2, 13, 5, 16, True, None),      # Sq > Skv: 8 rows see no key
    (1, 4, 1, 11, 4, 16, True, 2),         # Sq > Skv with a window
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_attention_bwd_matches_jax_vjp(case):
    b, hq, hkv, sq, skv, d, causal, window = case
    rng = np.random.default_rng(6)
    q, do = (rng.standard_normal((b, hq, sq, d)).astype(np.float32)
             for _ in "qg")
    k, v = (rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
            for _ in "kv")
    out, vjp = jax.vjp(lambda a, c, e: r_attn.attention(
        a, c, e, causal=causal, window=window), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    o = attn_ref.attention(tq, tk, tv, causal=causal, window=window)
    _close(o.numpy(), out)
    got = attn_ref.attention_bwd(tq, tk, tv, o, torch.tensor(do),
                                 causal=causal, window=window)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def test_rows_that_see_no_key_give_dv_and_no_dq():
    """Sq > Skv, causal: the first Sq - Skv rows attend uniformly to every
    key in the forward, so their do reaches dv as do / Skv, while dS is
    zeroed under the mask and their dq is 0."""
    rng = np.random.default_rng(7)
    q, do = (torch.tensor(rng.standard_normal((1, 2, 6, 16)),
                          dtype=torch.float32) for _ in "qg")
    k, v = (torch.tensor(rng.standard_normal((1, 2, 2, 16)),
                         dtype=torch.float32) for _ in "kv")
    do[:, :, 4:] = 0                        # only the keyless rows move
    o = attn_ref.attention(q, k, v)
    dq, dk, dv = attn_ref.attention_bwd(q, k, v, o, do)
    assert not dq.any() and not dk.any()
    torch.testing.assert_close(dv, do[:, :, :4].sum(2, keepdim=True)
                               .expand(-1, -1, 2, -1) / 2)


def test_cpu_function_runs_the_plain_backwards():
    """On CPU tensors each wrapper's Function calls the plain backward, at
    the strides autograd hands it (a heads view, an expanded gradient)."""
    rng = np.random.default_rng(8)
    y = torch.tensor(rng.standard_normal((2, 7, 3 * 16)), dtype=torch.float32)
    xv = y.view(2, 7, 3, 16).transpose(1, 2).requires_grad_()
    w = torch.tensor(rng.standard_normal(16), dtype=torch.float32,
                     requires_grad=True)
    rms.rmsnorm(xv, w).sum().backward()     # dy expanded, stride 0
    want = rms_ref.rmsnorm_bwd(xv.detach(), w.detach(),
                               torch.ones(xv.shape))
    assert torch.equal(xv.grad, want[0]) and torch.equal(w.grad, want[1])
    _, _, q, k, v, g = _inputs(2)
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = fa.flash_attention(*ts, window=3)
    out.backward(torch.tensor(g))
    want = attn_ref.attention_bwd(*(t.detach() for t in ts), out.detach(),
                                  torch.tensor(g), window=3)
    for t, w_ in zip(ts, want):
        assert torch.equal(t.grad, w_)


def test_backward_entry_points_refuse_what_they_cannot_take():
    x = torch.ones(2, 8)
    with pytest.raises(ValueError, match="does not match"):
        rms.rmsnorm_bwd(x, torch.ones(8), torch.ones(2, 4))
    with pytest.raises(ValueError, match="no RMSNorm kernel"):
        rms.rmsnorm_bwd(x.to("meta"), torch.ones(8, device="meta"),
                        x.to("meta"))
    q = torch.ones(1, 2, 3, 16)
    with pytest.raises(ValueError, match="must match q"):
        fa.flash_attention_bwd(q, q, q, q, q[:, :, :2])
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        m = q.to("meta")
        fa.flash_attention_bwd(m, m, m, m, m)


@pytest.mark.parametrize("d,dtype,aligned,want", [
    (128, torch.bfloat16, True, ("rows", 8, 4, 4)),    # q_norm's heads
    (5120, torch.bfloat16, True, ("rows", 8, 4, 256)),  # ln1, ln2
    (5120, torch.float32, True, ("rows", 4, 8, 256)),
    (7168, torch.float32, True, ("rows", 4, 8, 256)),   # zamba2's d_inner
    (37, torch.float32, True, ("rows", 1, 4, 16)),      # ragged width
    (64, torch.bfloat16, False, ("rows", 1, 4, 16)),    # unaligned
    (20000, torch.float32, True, ("loop", 1, 0, 256)),  # too wide
])
def test_backward_launch_plan(d, dtype, aligned, want):
    plan = rms.bwd_plan(d, dtype, aligned)
    assert (plan.kind, plan.vec, plan.maxv, plan.tpr) == want
    if plan.kind == "rows":
        # every vector of the row has a thread's register, and the block's
        # groups share their dw sums in at most 32 KB
        assert plan.tpr * plan.maxv * plan.vec >= d
        assert rms.BWD_BLOCK // plan.tpr * d * 4 <= 32 << 10 or \
            plan.tpr == rms.BWD_BLOCK


@gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2 ** -7)])
def test_kernels_gradients_equal_the_plain_routes_on_the_card(dtype, tol):
    """Through the kernels (the default route on the card) and through the
    plain versions (``impl="ref"``, autograd): each gradient within ``tol``
    of the largest plain one; every backward launches its kernel."""
    rng = np.random.default_rng(9)

    def t(shape):
        return torch.tensor(rng.standard_normal(shape), device="cuda",
                            dtype=torch.float32).to(dtype)

    y = t((2, 300, 5 * 128))
    x = y.view(2, 300, 5, 128).transpose(1, 2)      # a heads view
    w, dy = t((128,)), t((2, 5, 300, 128))
    q = t((2, 300, 8, 64)).transpose(1, 2)
    k, v = (t((2, 200, 2, 64)).transpose(1, 2) for _ in "kv")
    do = t((2, 8, 300, 64))

    def grads(impl):
        leaves = [a.detach().requires_grad_() for a in (x, w, q, k, v)]
        out = rms.rmsnorm(*leaves[:2], impl=impl)
        att = fa.flash_attention(*leaves[2:], impl=impl)
        return torch.autograd.grad((out, att), leaves, (dy, do))

    launches = (rms.rmsnorm_bwd.launches, fa.flash_attention_bwd.launches)
    got = grads(None)
    assert (rms.rmsnorm_bwd.launches, fa.flash_attention_bwd.launches) == \
        (launches[0] + 1, launches[1] + 1)
    want = grads("ref")
    for g, r in zip(got, want):
        assert g.dtype == r.dtype and g.shape == r.shape
        err = float((g.float() - r.float()).abs().max())
        assert err <= tol * float(r.float().abs().max())
    again = grads(None)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
