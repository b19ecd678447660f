"""The port's audio family (whisper) against the JAX package.

Reduced whisper-large-v3 (2 encoder and 2 decoder layers, d 64, 4 heads of
16), with the JAX parameters carried across by ``params_from_numpy`` and
the same inputs (token ids and float32 frames, numpy from a seed) through
both.  Float32 at 1e-4 (the same operations, reductions in another order);
bfloat16 at 5e-2 against the JAX package's arithmetic as its source writes
it (``torch_model_pair.as_written``).  The JAX side runs its plain
attention (``attn_impl="ref"``): its Pallas flash kernel does not run under
the installed JAX.  The decode cache's cross-attention KV starts as zeros
in both packages; the tests put the same numpy values into both, or fill
the port's from the encoder's memory through each decoder layer's own
``xattn`` projections, as ``layers.attention(memory=)`` computes them.
The ``gpu`` test runs the kernel path on a card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as r_layers
from repro.train.step import make_prefill_step as r_make_prefill_step
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.rmsnorm import kernel as rn_kernel
from repro_torch.models import layers
from repro_torch.models.common import params_from_numpy
from repro_torch.models.transformer import layer_params
from repro_torch.models.whisper import ENC_LEN
from repro_torch.train.step import make_prefill_step
from torch_model_pair import (BF16_TOL, F32_TOL, KEY, as_written, close,
                              pair, tokens)

ARCH = "whisper-large-v3"


def gpu(fn):
    """Needs a CUDA card: decided when the test runs, not at import."""
    fn = pytest.mark.skipif("not torch.cuda.is_available()",
                            reason="needs a CUDA card")(fn)
    return pytest.mark.gpu(fn)


def frames(cfg, b=2, s=24, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def fill_cross_kv(model, params, cache, frames_t):
    """Put the encoder's memory of ``frames_t`` into the cache's
    cross-attention KV, through each decoder layer's ``xattn.wk``/``wv``:
    the keys and values ``layers.attention(memory=)`` computes."""
    cfg = model.cfg
    memory = model.encode(params, frames_t)
    for i in range(cfg.n_layers):
        xp = layer_params(params["dec"], i)["xattn"]
        for name, w in (("xk", xp["wk"]), ("xv", xp["wv"])):
            cache[name][i] = layers._split_heads(memory @ w, cfg.n_kv_heads,
                                                 cfg.hd)
    return cache


def decode_both(p, toks, xkv):
    """Feed ``toks`` (B, S) one at a time through both packages'
    ``forward_decode`` with the same cross-attention KV ``xkv`` (numpy,
    (layers, B, Hkv, E, hd) each) in both caches → (JAX logits, port
    logits, JAX cache, port cache); the JAX step as written."""
    b, s = toks.shape
    enc_len = xkv[0].shape[3]
    r_cache = p.r_model.init_cache(b, s, enc_len=enc_len)
    cache = p.model.init_cache(b, s, enc_len=enc_len)
    for name, a in zip(("xk", "xv"), xkv):
        r_cache[name] = jnp.asarray(a).astype(r_cache[name].dtype)
        cache[name].copy_(torch.from_numpy(a))
    want, got = [], []
    for i in range(s):
        r_logits, r_cache = as_written(p.r_model.forward_decode, p.r_params,
                                       r_cache, jnp.asarray(toks[:, i:i + 1]),
                                       jnp.int32(i))
        logits, cache = p.model.forward_decode(
            p.params, cache, torch.from_numpy(toks[:, i:i + 1]), i)
        want.append(np.asarray(r_logits, np.float32)[:, 0])
        got.append(logits[:, 0].float().numpy())
    return np.stack(want), np.stack(got), r_cache, cache


def _xkv(cfg, b=2, enc_len=24, seed=1):
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, b, cfg.n_kv_heads, enc_len, cfg.hd)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for _ in "kv")


@pytest.mark.parametrize("qk_norm", [False, True])
def test_cross_attention_matches_jax(qk_norm):
    """``layers.attention(memory=)``: keys and values from the memory, no
    RoPE and no causal mask (``causal=True`` is ignored), against the
    reference's, with Sq != Skv."""
    p = pair(ARCH)
    cfg = dataclasses.replace(p.cfg, qk_norm=qk_norm)
    r_cfg = dataclasses.replace(p.r_model.cfg, qk_norm=qk_norm)
    r_p = r_layers.init_attention(KEY, r_cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, r_p), cfg)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    mem = rng.standard_normal((2, 19, 64)).astype(np.float32)
    pos = np.arange(7)
    want = r_layers.attention(r_p, jnp.asarray(x), r_cfg,
                              pos=jnp.asarray(pos), memory=jnp.asarray(mem))
    for causal in (True, False):
        got = layers.attention(tp, torch.from_numpy(x), cfg,
                               pos=torch.from_numpy(pos), causal=causal,
                               memory=torch.from_numpy(mem))
        assert got.shape == (2, 7, 64)
        close(got, want, F32_TOL)
    self_attn = layers.attention(tp, torch.from_numpy(x), cfg,
                                 pos=torch.from_numpy(pos))
    assert not np.allclose(self_attn.numpy(), np.asarray(want), atol=1e-2)


def test_encode_matches_jax():
    p = pair(ARCH)
    f = frames(p.cfg)
    want = p.r_model.encode(p.r_params, jnp.asarray(f))
    got = p.model.encode(p.params, torch.from_numpy(f))
    assert got.shape == (2, 24, 64) and got.dtype == torch.float32
    close(got, want, F32_TOL)


def test_forward_prefill_and_loss_match_jax():
    p = pair(ARCH)
    toks, f = tokens(p.cfg, s=12), frames(p.cfg)
    want = p.r_model.forward_train(p.r_params, jnp.asarray(toks),
                                   jnp.asarray(f))
    got = p.model.forward_train(p.params, torch.from_numpy(toks),
                                torch.from_numpy(f))
    assert got.shape == (2, 12, p.cfg.vocab_padded)
    close(got, want, F32_TOL)
    want = r_make_prefill_step(p.r_model)(
        p.r_params, {"tokens": jnp.asarray(toks),
                     "input_embeds": jnp.asarray(f)})
    got = make_prefill_step(p.model)(
        p.params, {"tokens": torch.from_numpy(toks),
                   "input_embeds": torch.from_numpy(f)})
    assert got.shape == (2, p.cfg.vocab_padded)
    close(got, want, F32_TOL)
    labels = np.roll(toks, -1, axis=1)
    want = p.r_model.loss(p.r_params, {"tokens": jnp.asarray(toks),
                                       "labels": jnp.asarray(labels),
                                       "input_embeds": jnp.asarray(f)})
    got = p.model.loss(p.params, {"tokens": torch.from_numpy(toks),
                                  "labels": torch.from_numpy(labels),
                                  "input_embeds": torch.from_numpy(f)})
    assert abs(float(got) - float(want)) <= F32_TOL


def test_decode_steps_match_jax_with_the_same_cross_kv():
    p = pair(ARCH)
    toks = tokens(p.cfg, s=8, seed=3)
    want, got, r_cache, cache = decode_both(p, toks, _xkv(p.cfg))
    close(got, want, F32_TOL)
    for name in ("k", "v", "xk", "xv"):
        close(cache[name], r_cache[name], F32_TOL)


def test_decode_matches_its_own_forward_with_the_cross_kv_filled():
    """The decode cache filled from the encoder's memory: token by token
    the decoder gives forward_train's logits at every position."""
    p = pair(ARCH)
    toks, f = tokens(p.cfg, b=1, s=10, seed=4), frames(p.cfg, b=1, seed=4)
    ft = torch.from_numpy(f)
    want = p.model.forward_train(p.params, torch.from_numpy(toks), ft)
    cache = fill_cross_kv(p.model, p.params,
                          p.model.init_cache(1, 10, enc_len=24), ft)
    for i in range(10):
        logits, cache = p.model.forward_decode(
            p.params, cache, torch.from_numpy(toks[:, i:i + 1]), i)
        close(logits[:, 0], want[:, i], F32_TOL)


def test_bfloat16_forward_prefill_and_decode_match_jax():
    p = pair(ARCH, "bfloat16")
    toks, f = tokens(p.cfg, s=12, seed=5), frames(p.cfg, seed=5)
    jt, jf = jnp.asarray(toks), jnp.asarray(f)
    tt, tf = torch.from_numpy(toks), torch.from_numpy(f)
    close(p.model.forward_train(p.params, tt, tf),
          as_written(p.r_model.forward_train, p.r_params, jt, jf), BF16_TOL)
    close(make_prefill_step(p.model)(p.params, {"tokens": tt,
                                                "input_embeds": tf}),
          as_written(r_make_prefill_step(p.r_model), p.r_params,
                     {"tokens": jt, "input_embeds": jf}), BF16_TOL)
    want, got, _, _ = decode_both(p, toks[:, :6], _xkv(p.cfg, seed=6))
    close(got, want, BF16_TOL)


def test_init_cache_shapes():
    p = pair(ARCH)
    cfg = p.cfg
    cache = p.model.init_cache(3, 5)
    assert cache["k"].shape == cache["v"].shape == (2, 3, 4, 5, 16)
    assert cache["xk"].shape == cache["xv"].shape == (2, 3, 4, ENC_LEN, 16)
    r_cache = p.r_model.init_cache(3, 5)
    assert {k: tuple(v.shape) for k, v in cache.items()} \
        == {k: v.shape for k, v in r_cache.items()}
    cache = p.model.init_cache(1, 4, dtype=torch.bfloat16, enc_len=7,
                               device="cpu")
    assert cache["xk"].shape == (cfg.n_layers, 1, 4, 7, 16)
    assert all(t.dtype == torch.bfloat16 and not t.any()
               for t in cache.values())


def test_init_matches_the_reference_layout():
    p = pair(ARCH, "bfloat16")
    params = p.model.init(torch.Generator().manual_seed(0))
    mine = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), params)
    theirs = jax.tree.map(lambda a: (a.shape, jnp.dtype(a.dtype).name),
                          p.r_params)
    assert mine == theirs
    assert params["enc"]["attn"]["wq"].shape[0] == p.cfg.enc_layers
    assert params["dec"]["xattn"]["wk"].shape[0] == p.cfg.n_layers


def test_forward_needs_input_embeds():
    p = pair(ARCH)
    with pytest.raises(ValueError, match="needs input_embeds"):
        p.model.forward_train(p.params, torch.from_numpy(tokens(p.cfg)))


# ---------------------------------------------------------------- on a card
@gpu
def test_kernel_path_matches_the_plain_path_on_the_card():
    """Reduced whisper in bfloat16 on the card: a prefill step launches
    flash attention for the encoder's self-attention, the decoder's and
    its cross-attention, a decode step once a layer for the
    cross-attention, and both agree with the plain path on the CPU."""
    p = pair(ARCH, "bfloat16")
    cfg = p.cfg
    on_card = jax.tree.map(lambda t: t.to("cuda"), p.params)
    toks, f = tokens(cfg, s=12, seed=7), frames(cfg, seed=7)
    batch = {"tokens": torch.from_numpy(toks), "input_embeds":
             torch.from_numpy(f)}
    step = make_prefill_step(p.model)
    fa_before, rn_before = (fa_kernel.flash_attention.launches,
                            rn_kernel.rmsnorm.launches)
    got = step(on_card, {k: v.to("cuda") for k, v in batch.items()})
    assert fa_kernel.flash_attention.launches \
        == fa_before + cfg.enc_layers + 2 * cfg.n_layers
    assert rn_kernel.rmsnorm.launches \
        == rn_before + 2 * cfg.enc_layers + 3 * cfg.n_layers + 1
    close(got, step(p.params, batch), BF16_TOL)
    ft = torch.from_numpy(f)
    cache = fill_cross_kv(p.model, on_card, p.model.init_cache(
        2, 4, enc_len=24, device="cuda"), ft.to("cuda"))
    cpu_cache = fill_cross_kv(p.model, p.params,
                              p.model.init_cache(2, 4, enc_len=24), ft)
    for i in range(4):
        tok = torch.from_numpy(toks[:, i:i + 1])
        before = fa_kernel.flash_attention.launches
        logits, cache = p.model.forward_decode(on_card, cache,
                                               tok.to("cuda"), i)
        assert fa_kernel.flash_attention.launches == before + cfg.n_layers
        want, cpu_cache = p.model.forward_decode(p.params, cpu_cache, tok, i)
        close(logits, want, BF16_TOL)
