"""The kernels refuse to take part in autograd; the plain route keeps it.

The CUDA kernels of flash attention and RMSNorm write their outputs
through ctypes into tensors autograd never sees, so a gradient taken
through them would silently be dropped.  Each wrapper therefore raises on
its kernel route when grad mode is on and an input requires grad
(``repro_torch.kernels.refuse_grad``), until the backward kernels of the
training item land.  The plain route (CPU tensors, or ``impl="ref"``) is
differentiable, and its gradients equal ``jax.grad`` of the JAX package's
plain versions on the same inputs (float32, 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ref as r_attn
from repro.kernels.rmsnorm import ref as r_rms
from repro_torch.kernels import refuse_grad
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.rmsnorm import kernel as rms

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


def test_refuse_grad_raises_only_with_grad_mode_and_a_grad_input():
    a = torch.ones(3, requires_grad=True)
    b = torch.ones(3)
    with pytest.raises(RuntimeError, match="training item of ROADMAP"):
        refuse_grad("k", b, a)
    refuse_grad("k", b, b)                     # nothing requires grad
    with torch.no_grad():
        refuse_grad("k", a, b)
    with torch.inference_mode():
        refuse_grad("k", a)
    with torch.enable_grad():
        with pytest.raises(RuntimeError, match="^k: the CUDA kernel"):
            refuse_grad("k", a)


@pytest.mark.parametrize("impl", [None, "ref"])
def test_plain_rmsnorm_route_gives_the_reference_gradients(impl):
    x, w, *_ = _inputs()
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    out = rms.rmsnorm(xt, wt, impl=impl)
    (out * out).sum().backward()
    gx, gw = jax.grad(lambda a, b: jnp.sum(r_rms.rmsnorm(a, b) ** 2),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw),
                               rtol=GRAD_TOL, atol=GRAD_TOL)


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
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


@gpu
def test_kernels_refuse_grad_on_the_card():
    x, w, q, k, v, _ = _inputs()
    dev = "cuda"
    xt = torch.tensor(x, device=dev, requires_grad=True)
    wt = torch.tensor(w, device=dev)
    with pytest.raises(RuntimeError, match="rmsnorm: the CUDA kernel"):
        rms.rmsnorm(xt, wt)
    qt, kt, vt = (torch.tensor(a, device=dev) for a in (q, k, v))
    qt.requires_grad_(True)
    with pytest.raises(RuntimeError, match="flash_attention: the CUDA"):
        fa.flash_attention(qt, kt, vt)
    launches = (rms.rmsnorm.launches, fa.flash_attention.launches)
    # no launch was made; under no_grad the kernels run and agree with the
    # plain route
    assert (rms.rmsnorm.launches, fa.flash_attention.launches) == launches
    with torch.no_grad():
        got = rms.rmsnorm(xt, wt)
        want = rms.rmsnorm(xt, wt, impl="ref")
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        got = fa.flash_attention(qt, kt, vt)
        want = fa.flash_attention(qt, kt, vt, impl="ref")
        torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)
    # the plain route on the card still carries the graph
    out = rms.rmsnorm(xt, wt, impl="ref")
    out.sum().backward()
    assert xt.grad is not None and torch.isfinite(xt.grad).all()
