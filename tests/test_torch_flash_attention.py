"""The port's attention against the JAX package.

Same inputs (numpy, from a seed) through ``repro``'s plain
``kernels/flash_attention/ref.py`` and the port's plain version (the Pallas
kernel itself does not run under the installed JAX).  Tolerances are those
of ``tests/test_kernels.py``: 2e-3 for float32 (the sums run in another
order) and 2e-2 for bfloat16 (one rounding of the output, taken by two
frameworks).  The ``gpu`` tests hold the CUDA kernel against the plain
version on a card, over the cases ``chip_smoke.py`` runs at full size.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ref as r_ref
from repro_torch.kernels.flash_attention import kernel, ops, ref

TOL = {"float32": 2e-3, "bfloat16": 2e-2}

# (b, hq, hkv, sq, skv, d, causal, window): GQA groups 1, 4, 5 and 8,
# causal and not, windows 32 and 128, Sq < Skv (end alignment), Sq > Skv,
# lengths that divide no tile
CASES = [
    (1, 4, 4, 32, 32, 16, True, None),
    (2, 8, 2, 48, 48, 32, True, None),
    (1, 10, 2, 40, 40, 64, True, None),
    (1, 8, 1, 24, 24, 16, False, None),
    (1, 5, 1, 37, 53, 32, False, None),
    (1, 4, 2, 70, 70, 16, True, 32),
    (1, 4, 2, 160, 160, 16, True, 128),
    (1, 4, 2, 50, 50, 16, False, 32),
    (2, 4, 2, 9, 33, 64, True, None),
    (1, 5, 1, 40, 17, 32, True, None),
    (1, 4, 4, 1, 29, 128, True, None),
    (1, 4, 2, 33, 65, 128, True, 7),
]


def gpu(fn):
    """Needs a CUDA card: decided when the test runs, not at import."""
    fn = pytest.mark.skipif("not torch.cuda.is_available()",
                            reason="needs a CUDA card")(fn)
    return pytest.mark.gpu(fn)


def _qkv(b, hq, hkv, sq, skv, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32))


def _torch(arrays, dtype, device="cpu"):
    return [torch.from_numpy(a).to(device, getattr(torch, dtype))
            for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_matches_jax_ref(case, dtype):
    b, hq, hkv, sq, skv, d, causal, window = case
    arrays = _qkv(b, hq, hkv, sq, skv, d)
    jq, jk, jv = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays)
    tq, tk, tv = _torch(arrays, dtype)
    got = ops.attention(tq, tk, tv, causal=causal, window=window)
    want = r_ref.attention(jq, jk, jv, causal=causal, window=window)
    assert got.shape == (b, hq, sq, d) and got.dtype == tq.dtype
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_rows_that_see_no_key_average_every_value():
    """Sq > Skv, causal: the first Sq - Skv rows precede every key and get
    the mean of v (as the JAX package's ref.py gives)."""
    q, k, v = _torch(_qkv(1, 5, 1, 12, 4, 16, seed=1), "float32")
    out = ops.attention(q, k, v, causal=True)
    want = v.mean(dim=2, keepdim=True).expand(1, 5, 8, 16)
    torch.testing.assert_close(out[:, :, :8], want, rtol=1e-6, atol=1e-6)
    # the rest are causal attention over the keys they do see
    torch.testing.assert_close(
        out[:, :, 8:], ops.attention(q[:, :, 8:], k, v, causal=True))


def test_scale_and_decode_attention():
    arrays = _qkv(2, 4, 2, 1, 9, 32, seed=2)
    tq, tk, tv = _torch(arrays, "float32")
    jq, jk, jv = (jnp.asarray(a) for a in arrays)
    np.testing.assert_allclose(
        ref.decode_attention(tq, tk, tv, window=4).numpy(),
        np.asarray(r_ref.decode_attention(jq, jk, jv, window=4)),
        rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(
        ops.attention(tq, tk, tv, scale=0.3, causal=False).numpy(),
        np.asarray(r_ref.attention(jq, jk, jv, scale=0.3, causal=False)),
        rtol=2e-3, atol=2e-3)


def test_strided_heads_view_is_taken_as_is():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 20, 4, 16)).astype(np.float32))
    view = x.transpose(1, 2)                       # (B, H, S, D) view
    got = ops.attention(view, view[:, :2], view[:, :2])
    want = ops.attention(view.contiguous(), view[:, :2].contiguous(),
                         view[:, :2].contiguous())
    torch.testing.assert_close(got, want)


def test_wrapper_validates():
    q, k = torch.zeros((1, 4, 8, 16)), torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="multiple|fit"):
        kernel.flash_attention(q, torch.zeros((1, 3, 8, 16)),
                               torch.zeros((1, 3, 8, 16)))
    with pytest.raises(ValueError, match="4-d"):
        kernel.flash_attention(q[0], k, k)
    with pytest.raises(ValueError, match="all be float32"):
        kernel.flash_attention(q, k.to(torch.bfloat16), k)
    with pytest.raises(ValueError, match="window"):
        kernel.flash_attention(q, k, k, window=0)
    with pytest.raises(ValueError, match="no keys"):
        kernel.flash_attention(q, k[:, :, :0], k[:, :, :0])
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        kernel.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))
    with pytest.raises(ValueError, match="CUDA device"):
        ops.attention(q, k, k, impl="kernel")
    with pytest.raises(ValueError, match="unknown"):
        ops.attention(q, k, k, impl="pallas")


def test_cpu_tensors_never_launch_or_build():
    launches = kernel.flash_attention.launches
    builds = kernel.LIBRARY.builds
    q, k = torch.ones((1, 4, 8, 16)), torch.ones((1, 2, 8, 16))
    ops.attention(q, k, k)
    assert kernel.flash_attention.launches == launches
    assert kernel.LIBRARY.builds == builds


# ---------------------------------------------------------------- on a card
@gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES + [
    (2, 40, 8, 300, 300, 128, True, None),
    (1, 8, 8, 129, 257, 64, False, 100)], ids=str)
def test_cuda_kernel_matches_plain(case, dtype):
    b, hq, hkv, sq, skv, d, causal, window = case
    q, k, v = _torch(_qkv(b, hq, hkv, sq, skv, d, seed=5), dtype, "cuda")
    before = kernel.flash_attention.launches
    got = ops.attention(q, k, v, causal=causal, window=window)
    assert kernel.flash_attention.launches == before + 1
    want = ref.attention(q, k, v, causal=causal, window=window)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
