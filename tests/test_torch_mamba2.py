"""The port's Mamba2 family against the JAX package.

Reduced mamba2-370m (d 64, state 16, head dim 16, chunk 8), with the JAX
parameters carried across by ``params_from_numpy`` (``A_log``, ``D`` and
``dt_bias`` stay float32) and the same inputs through both.  Float32 at
1e-4 (the same operations; the SSD's einsums contracted in another order),
bfloat16 at 5e-2.  ``ssd_chunked`` is held on its own at both
``compute_dtype``s, on decay rates and steps drawn so that the decay
matrix spans many orders of magnitude.  On the CPU the RMSNorm calls take
the plain version; the ``gpu`` test runs the kernel path on a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as r_mamba2
from repro.train.step import make_prefill_step as r_make_prefill_step
from repro_torch.kernels.rmsnorm import kernel as rn_kernel
from repro_torch.models import mamba2
from repro_torch.train.step import make_prefill_step
from torch_model_pair import (BF16_TOL, F32_TOL, close, decode_both, pair,
                              tokens)

ARCH = "mamba2-370m"


def gpu(fn):
    """Needs a CUDA card: decided when the test runs, not at import."""
    fn = pytest.mark.skipif("not torch.cuda.is_available()",
                            reason="needs a CUDA card")(fn)
    return pytest.mark.gpu(fn)


def _ssd_inputs(b=2, s=24, h=3, pd=4, n=5, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, pd)).astype(np.float32),
            rng.uniform(0.01, 2.0, (b, s, h)).astype(np.float32),
            -rng.uniform(0.1, 3.0, h).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunked_matches_jax(dtype):
    args = _ssd_inputs()
    want_y, want_state = r_mamba2.ssd_chunked(
        *map(jnp.asarray, args), chunk=8, compute_dtype=getattr(jnp, dtype))
    y, state = mamba2.ssd_chunked(*map(torch.from_numpy, args), chunk=8,
                                  compute_dtype=getattr(torch, dtype))
    assert y.dtype == state.dtype == torch.float32
    assert y.shape == (2, 24, 3, 4) and state.shape == (2, 3, 4, 5)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    close(y, want_y, tol)
    close(state, want_state, tol)


def test_ssd_chunked_is_one_recurrence():
    """The chunked form equals the token-by-token recurrence that decode
    runs, whatever the chunk."""
    x, dt, a, bm, cm = map(torch.from_numpy, _ssd_inputs(seed=1))
    state = torch.zeros(2, 3, 4, 5)
    ys = []
    for t in range(x.shape[1]):
        decay = torch.exp(dt[:, t, :, None, None] * a[:, None, None])
        state = state * decay + (x[:, t] * dt[:, t, :, None])[..., None] \
            * bm[:, t, None, None]
        ys.append((state @ cm[:, t, None, :, None])[..., 0])
    for chunk in (1, 4, 8, 24):
        y, final = mamba2.ssd_chunked(x, dt, a, bm, cm, chunk=chunk)
        close(y, torch.stack(ys, 1).numpy(), F32_TOL)
        close(final, state.numpy(), F32_TOL)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        mamba2.ssd_chunked(x, dt, a, bm, cm, chunk=5)


def test_segsum_and_causal_conv_match_jax():
    rng = np.random.default_rng(2)
    a = -rng.uniform(0, 50, (2, 3, 8)).astype(np.float32)
    seg = mamba2._segsum(torch.from_numpy(a))
    want = np.asarray(r_mamba2._segsum(jnp.asarray(a)))
    assert np.array_equal(np.isneginf(seg.numpy()), np.isneginf(want))
    finite = np.isfinite(want)
    close(seg.numpy()[finite], want[finite], F32_TOL)
    assert not bool(torch.isnan(torch.exp(seg)).any())
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    close(mamba2._causal_conv(torch.from_numpy(x), torch.from_numpy(w)),
          r_mamba2._causal_conv(jnp.asarray(x), jnp.asarray(w)), F32_TOL)


@pytest.mark.parametrize("ssd_dtype", ["f32", "bf16"])
def test_forward_prefill_and_loss_match_jax(ssd_dtype):
    p = pair(ARCH, ssd_dtype=ssd_dtype)
    assert p.model.ssd_dtype == {"f32": torch.float32,
                                 "bf16": torch.bfloat16}[ssd_dtype]
    tol = F32_TOL if ssd_dtype == "f32" else BF16_TOL
    toks = tokens(p.cfg, s=24)                   # three chunks
    want = p.r_model.forward_train(p.r_params, jnp.asarray(toks))
    got = p.model.forward_train(p.params, torch.from_numpy(toks))
    assert got.shape == (2, 24, p.cfg.vocab_padded)
    close(got, want, tol)
    want = r_make_prefill_step(p.r_model)(p.r_params,
                                          {"tokens": jnp.asarray(toks)})
    got = make_prefill_step(p.model)(p.params,
                                     {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, p.cfg.vocab_padded)
    close(got, want, tol)
    labels = np.roll(toks, -1, axis=1)
    want = p.r_model.loss(p.r_params, {"tokens": jnp.asarray(toks),
                                       "labels": jnp.asarray(labels)})
    got = p.model.loss(p.params, {"tokens": torch.from_numpy(toks),
                                  "labels": torch.from_numpy(labels)})
    assert abs(float(got) - float(want)) <= tol


@pytest.mark.parametrize("cache_dtype", [None, "float32"])
def test_decode_steps_match_jax(cache_dtype):
    p = pair(ARCH)
    toks = tokens(p.cfg, s=12, seed=3)
    want, got, r_cache, cache = decode_both(p, toks, cache_dtype)
    close(got, want, F32_TOL)
    assert cache["state"].dtype == torch.float32
    close(cache["conv"], r_cache["conv"], F32_TOL)
    close(cache["state"], r_cache["state"], F32_TOL)


def test_decode_matches_its_own_forward():
    """The recurrence of decode against the chunked scan of forward, over
    two chunks."""
    p = pair(ARCH)
    toks = tokens(p.cfg, b=1, s=16, seed=4)
    want = p.model.forward_train(p.params, torch.from_numpy(toks))
    _, got, _, _ = decode_both(p, toks)
    close(got.transpose(1, 0, 2), want, F32_TOL)


def test_bfloat16_forward_and_decode_match_jax():
    p = pair(ARCH, "bfloat16")
    leaves = p.params["layers"]["mamba"]
    assert {k: str(v.dtype)[6:] for k, v in leaves.items()} == {
        "in_proj": "bfloat16", "conv_w": "bfloat16", "A_log": "float32",
        "D": "float32", "dt_bias": "float32", "norm": "bfloat16",
        "out_proj": "bfloat16"}
    toks = tokens(p.cfg, s=16, seed=5)
    close(p.model.forward_train(p.params, torch.from_numpy(toks)),
          p.r_model.forward_train(p.r_params, jnp.asarray(toks)), BF16_TOL)
    want, got, _, _ = decode_both(p, toks[:, :6])
    close(got, want, BF16_TOL)


def test_init_matches_the_reference_layout():
    p = pair(ARCH, "bfloat16")
    params = p.model.init(torch.Generator().manual_seed(0))
    mine = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), params)
    theirs = jax.tree.map(lambda a: (a.shape, jnp.dtype(a.dtype).name),
                          p.r_params)
    assert mine == theirs
    for name in ("A_log", "D", "dt_bias", "norm"):   # constants, as in JAX
        assert torch.equal(params["layers"]["mamba"][name].float(),
                           torch.from_numpy(np.array(
                               p.r_params["layers"]["mamba"][name],
                               np.float32)))


def test_forward_refuses_input_embeds_and_ragged_chunks():
    p = pair(ARCH)
    toks = torch.from_numpy(tokens(p.cfg, s=8))
    with pytest.raises(ValueError, match="no frontend"):
        p.model.forward_train(p.params, toks, torch.zeros(2, 1, 64))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        p.model.forward_train(p.params, toks[:, :6])


# ---------------------------------------------------------------- on a card
@gpu
def test_kernel_path_matches_the_plain_path_on_the_card():
    """Reduced mamba2 in bfloat16 on the card: prefill and decode launch
    RMSNorm (the layer norm, the gated norm of d_inner and the final
    norm), agree with the plain path on the CPU, and repeat bit for bit."""
    p = pair(ARCH, "bfloat16")
    on_card = jax.tree.map(lambda t: t.to("cuda"), p.params)
    toks = tokens(p.cfg, s=16, seed=6)
    step = make_prefill_step(p.model)
    before = rn_kernel.rmsnorm.launches
    got = step(on_card, {"tokens": torch.from_numpy(toks).to("cuda")})
    assert rn_kernel.rmsnorm.launches == before + 2 * p.cfg.n_layers + 1
    assert torch.equal(got, step(on_card, {
        "tokens": torch.from_numpy(toks).to("cuda")}))
    close(got, step(p.params, {"tokens": torch.from_numpy(toks)}), BF16_TOL)
    cache = p.model.init_cache(2, 4, device="cuda")
    cpu_cache = p.model.init_cache(2, 4)
    for i in range(4):
        tok = torch.from_numpy(toks[:, i:i + 1])
        logits, cache = p.model.forward_decode(on_card, cache,
                                               tok.to("cuda"), i)
        want, cpu_cache = p.model.forward_decode(p.params, cpu_cache, tok, i)
        close(logits, want, BF16_TOL)
