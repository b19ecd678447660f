"""The port's attention against the JAX package.

Same inputs (numpy, from a seed) through ``repro``'s plain
``kernels/flash_attention/ref.py`` and the port's plain version (the Pallas
kernel itself does not run under the installed JAX).  Tolerances are those
of ``tests/test_kernels.py``: 2e-3 for float32 (the sums run in another
order) and 2e-2 for bfloat16 (one rounding of the output, taken by two
frameworks).

The bfloat16 tensor-core kernel (``csrc/flash_attention_wgmma.cu``) adds one
rounding to that arithmetic, P -> bfloat16 before P V, and is held to
:func:`tensor_core_limit`; a plain emulation of its arithmetic holds the
limit itself on the CPU.  The ``gpu`` tests hold both CUDA kernels against
the plain version on a card, over the cases ``chip_smoke.py`` runs at full
size; run them there with ``python -m pytest -m gpu
tests/test_torch_flash_attention.py``.
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
# lengths that divide no tile; head dim 112 (zamba2) causal, not causal
# with Sq != Skv, and Sq > Skv; whisper's cross-attention (not causal, one
# query row or many against more keys, at D 64)
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
    (1, 4, 2, 40, 40, 112, True, None),
    (1, 4, 4, 24, 75, 112, False, None),
    (1, 8, 2, 50, 30, 112, True, None),
    (2, 4, 4, 1, 150, 64, False, None),
    (1, 4, 4, 45, 150, 64, False, None),
]


def tensor_core_limit(q, k, v, want, *, causal=True, window=None):
    """The bound of the tensor-core route against the plain version
    ``want``: 1e-4 + 2^-7 |plain| for one bfloat16 rounding of the output
    (the float32 sums' order shows near 0), plus 2^-7 plain(|v|) for P ->
    bfloat16, whose unit roundoff 2^-8 moves an output by at most 2^-8
    sum(p |v|) / l, with the same factor 2 of margin."""
    w_abs = ref.attention(q, k, v.abs(), causal=causal, window=window)
    return 1e-4 + 2.0 ** -7 * (want.float().abs() + w_abs.float())


def tensor_core_emulation(q, k, v, *, causal=True, window=None,
                          drop_last=0):
    """The wgmma kernel's arithmetic, plain: float32 scores from bfloat16
    operands (whose products are exact in float32), scaled after the
    product, masked with -1e30, P = exp(S - row max) in float32, the
    denominator summed from the unrounded P, P rounded to bfloat16 for
    P V, the output rounded to bfloat16.  ``drop_last`` plants a fault:
    the last keys count as absent."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    group = hq // hkv
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * d ** -0.5
    q_pos = torch.arange(sq)[:, None] + (skv - sq)
    k_pos = torch.arange(skv)[None, :]
    keep = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        keep &= k_pos <= q_pos
    if window is not None:
        keep &= k_pos > q_pos - window
    s = torch.where(keep, s, ref.NEG_INF)
    if drop_last:
        s[..., skv - drop_last:] = -torch.inf
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(), vf)
    return (out / l).to(torch.bfloat16)


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
    by_route = dict(kernel.flash_attention.launches_by_route)
    builds = [lib.builds for lib in kernel.LIBRARIES.values()]
    q, k = torch.ones((1, 4, 8, 16)), torch.ones((1, 2, 8, 16))
    ops.attention(q, k, k)
    ops.attention(q.bfloat16(), k.bfloat16(), k.bfloat16())
    assert kernel.flash_attention.launches == launches
    assert kernel.flash_attention.launches_by_route == by_route
    assert [lib.builds for lib in kernel.LIBRARIES.values()] == builds


LIMIT_CASES = CASES + [(1, 40, 8, 512, 512, 128, True, None)]


@pytest.mark.parametrize("case", LIMIT_CASES, ids=str)
def test_tensor_core_arithmetic_lies_within_its_limit(case):
    """The limit holds the emulated tensor-core arithmetic against the
    plain version, at every case in bfloat16."""
    b, hq, hkv, sq, skv, d, causal, window = case
    q, k, v = _torch(_qkv(b, hq, hkv, sq, skv, d, seed=6), "bfloat16")
    want = ref.attention(q, k, v, causal=causal, window=window)
    got = tensor_core_emulation(q, k, v, causal=causal, window=window)
    limit = tensor_core_limit(q, k, v, want, causal=causal, window=window)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    share = ((got.float() - want.float()).abs() / limit).max()
    assert share <= 1.0, float(share)


@pytest.mark.parametrize("fault", ["GQA map shifted by one head",
                                   "last 16 keys dropped"])
@pytest.mark.parametrize("case", [c for c in LIMIT_CASES
                                  if c[2] > 1 and c[4] > 16], ids=str)
def test_tensor_core_limit_catches_planted_faults(case, fault):
    b, hq, hkv, sq, skv, d, causal, window = case
    q, k, v = _torch(_qkv(b, hq, hkv, sq, skv, d, seed=6), "bfloat16")
    want = ref.attention(q, k, v, causal=causal, window=window)
    limit = tensor_core_limit(q, k, v, want, causal=causal, window=window)
    if fault.startswith("GQA"):
        got = tensor_core_emulation(q, k.roll(-1, 1), v.roll(-1, 1),
                                    causal=causal, window=window)
    else:
        got = tensor_core_emulation(q, k, v, causal=causal, window=window,
                                    drop_last=16)
    assert ((got.float() - want.float()).abs() > limit).any()


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 112, "wgmma"),
    (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 16, "simt"), (torch.bfloat16, 32, "simt"),
    (torch.float32, 16, "simt"), (torch.float32, 32, "simt"),
    (torch.float32, 64, "simt"), (torch.float32, 112, "simt"),
    (torch.float32, 128, "simt")])
def test_route_is_chosen_by_dtype_and_head_dim(dtype, d, want):
    assert kernel.route(dtype, d) == want


def test_route_refuses_other_head_dims_and_dtypes():
    with pytest.raises(ValueError, match="head dim 96"):
        kernel.route(torch.bfloat16, 96)
    with pytest.raises(ValueError, match="head dim 80"):
        kernel.route(torch.float32, 80)
    with pytest.raises(ValueError, match="float16"):
        kernel.route(torch.float16, 128)


# ---------------------------------------------------------------- on a card
@gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES + [
    (2, 40, 8, 300, 300, 128, True, None),
    (1, 8, 8, 129, 257, 64, False, 100),
    (2, 32, 32, 300, 300, 112, True, None),
    (1, 32, 32, 130, 1000, 112, False, None),
    (1, 20, 20, 448, 1500, 64, False, None),
    (4, 20, 20, 1, 1500, 64, False, None)], ids=str)
def test_cuda_kernel_matches_plain(case, dtype):
    b, hq, hkv, sq, skv, d, causal, window = case
    q, k, v = _torch(_qkv(b, hq, hkv, sq, skv, d, seed=5), dtype, "cuda")
    route = kernel.route(q.dtype, d)
    before = kernel.flash_attention.launches
    by_route = kernel.flash_attention.launches_by_route[route]
    got = ops.attention(q, k, v, causal=causal, window=window)
    assert kernel.flash_attention.launches == before + 1
    assert kernel.flash_attention.launches_by_route[route] == by_route + 1
    want = ref.attention(q, k, v, causal=causal, window=window)
    if route == "wgmma":
        limit = tensor_core_limit(q, k, v, want, causal=causal,
                                  window=window)
        assert bool(torch.isfinite(got.float()).all())
        share = ((got.float() - want.float()).abs() / limit).max()
        assert share <= 1.0, float(share)
    else:
        tol = TOL[dtype]
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


@gpu
@pytest.mark.parametrize("hq,hkv,d", [(40, 8, 128), (32, 32, 112)],
                         ids=["qwen3-14b", "zamba2-7b"])
def test_cuda_tensor_core_kernel_on_the_heads_view(hq, hkv, d):
    """The path's heads views (B, H, S, D) of (B, S, H*D) projections, at
    S = 1024 with qwen3-14b's and zamba2-7b's heads, taken at their
    strides."""
    rng = np.random.default_rng(7)
    b, s = 2, 1024

    def heads(h):
        x = torch.from_numpy(rng.standard_normal((b, s, h * d))
                             .astype(np.float32))
        return x.to("cuda", torch.bfloat16).view(b, s, h, d).transpose(1, 2)
    q, k, v = heads(hq), heads(hkv), heads(hkv)
    by_route = kernel.flash_attention.launches_by_route["wgmma"]
    got = ops.attention(q, k, v)
    assert kernel.flash_attention.launches_by_route["wgmma"] == by_route + 1
    want = ref.attention(q, k, v)
    share = ((got.float() - want.float()).abs()
             / tensor_core_limit(q, k, v, want)).max()
    assert got.is_contiguous() and share <= 1.0, float(share)
