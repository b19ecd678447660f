"""The port's hybrid family (zamba2) against the JAX package.

Reduced zamba2-7b (4 Mamba2 layers, d 64, a shared attention block after
layers 0 and 2, so two sites and two KV caches), with the JAX parameters
carried across by ``params_from_numpy`` (the unstacked ``shared`` tree
included) and the same inputs through both.  Float32 at 1e-4 (the same
operations, reductions in another order).  In bfloat16 each block (a Mamba2
layer, a site of the shared block, in forward and in decode) is held at
5e-2 against the JAX package's block on the same input: over the whole
stack of six blocks the two packages drift apart by about a bfloat16
rounding a block (the logits by up to 0.14 on logits of 4), while each
stays as close to the float32 model on the same weights as the other, which
is what the end-to-end bfloat16 check holds.  The JAX side
runs its plain attention (``attn_impl="ref"``): its Pallas flash kernel
does not run under the installed JAX.  On the CPU the port's attention and
RMSNorm calls take their plain versions; the ``gpu`` test runs the kernel
path on a card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as r_layers
from repro.models import mamba2 as r_mamba2
from repro.models.registry import build_model as r_build_model
from repro.train.step import make_prefill_step as r_make_prefill_step
from repro_torch.configs import registry as configs
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.rmsnorm import kernel as rn_kernel
from repro_torch.models.common import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import layer_params
from repro_torch.models.zamba2 import HybridLM
from repro_torch.train.step import make_prefill_step
from torch_model_pair import (BF16_TOL, F32_TOL, as_f32, close, decode_both,
                              pair, tokens)

ARCH = "zamba2-7b"


def gpu(fn):
    """Needs a CUDA card: decided when the test runs, not at import."""
    fn = pytest.mark.skipif("not torch.cuda.is_available()",
                            reason="needs a CUDA card")(fn)
    return pytest.mark.gpu(fn)


def test_attention_sites():
    p = pair(ARCH)
    assert p.model.n_attn_sites == p.r_model.n_attn_sites == 2
    assert [p.model.attn_site(i) for i in range(4)] == [0, None, 1, None]
    full = HybridLM(configs.get_arch(ARCH))
    assert full.n_attn_sites == 14          # 81 layers, one site every 6
    assert [i for i in range(81) if full.attn_site(i) is not None] \
        == list(range(0, 81, 6))


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
    """Token by token against JAX's jitted decode, each site's KV cache
    equal to JAX's after every prompt token is in."""
    p = pair(ARCH)
    toks = tokens(p.cfg, s=10, seed=3)
    want, got, r_cache, cache = decode_both(p, toks, cache_dtype)
    close(got, want, F32_TOL)
    assert cache["attn_k"].shape == (2, 2, p.cfg.n_kv_heads, 10, p.cfg.hd)
    for name in ("attn_k", "attn_v", "conv", "state"):
        close(cache[name], r_cache[name], F32_TOL)
    # both sites were written at every position
    assert bool((cache["attn_k"].abs().sum(-1) > 0).all())


def test_decode_matches_its_own_forward():
    """The recurrence and per-site KV of decode against the chunked scan
    and full attention of forward, over two chunks."""
    p = pair(ARCH)
    toks = tokens(p.cfg, b=1, s=16, seed=4)
    want = p.model.forward_train(p.params, torch.from_numpy(toks))
    _, got, _, _ = decode_both(p, toks)
    close(got.transpose(1, 0, 2), want, F32_TOL)


def _to_jax(t: torch.Tensor, like):
    """A port tensor as a JAX array of ``like``'s dtype, bit for bit, on
    its own copy: a float32 tensor's numpy view shares its memory, JAX may
    alias a numpy buffer, and its dispatch is asynchronous, so the port's
    in-place cache updates could otherwise reach a JAX call still queued."""
    return jnp.asarray(np.array(as_f32(t))).astype(like)


def forward_blocks(p, toks):
    """The forward pass block by block, each Mamba2 layer and each site of
    the shared block run by both packages on the port's input to it →
    [(block, port output, JAX output)].  JAX's blocks are jitted, as in
    its layer scan."""
    cfg, r_cfg, dt = p.cfg, p.r_model.cfg, p.r_model.cfg.dtype
    r_layer = jax.jit(lambda lp, x: x + r_mamba2.mamba_block(
        lp["mamba"], r_layers.rmsnorm(x, lp["ln"], cfg.norm_eps), r_cfg,
        ssd_dtype=p.r_model.ssd_dtype))
    r_shared = jax.jit(p.r_model._shared_block)
    x = p.params["lm"]["embed"][torch.from_numpy(toks)]
    s = toks.shape[1]
    out = []
    for i in range(cfg.n_layers):
        want = r_layer(jax.tree.map(lambda a: a[i], p.r_params["layers"]),
                       _to_jax(x, dt))
        x = p.model._layer_train(x, layer_params(p.params["layers"], i))
        out.append((f"layer {i}", x, want))
        site = p.model.attn_site(i)
        if site is not None:
            want = r_shared(p.r_params["shared"], _to_jax(x, dt),
                            jnp.arange(s))
            x = p.model._shared_block(p.params["shared"], x, torch.arange(s))
            out.append((f"site {site}", x, want))
    return out


def decode_blocks(p, toks):
    """Decode token by token, block by block: each block run by both
    packages on the port's input and the port's cache entries before it →
    [(block, port output, JAX output)], the updated conv window, state and
    site KV among the outputs.  The JAX blocks are the reference's scan
    body and ``with_attn`` branch (``repro/models/zamba2.py``), jitted."""
    cfg, r_cfg, dt = p.cfg, p.r_model.cfg, p.r_model.cfg.dtype
    eps = cfg.norm_eps

    @jax.jit
    def r_layer(lp, x, conv, state):
        o, conv, state = r_mamba2.mamba_block(
            lp["mamba"], r_layers.rmsnorm(x, lp["ln"], eps), r_cfg,
            conv_state=conv, ssm_state=state, decode=True)
        return x + o, conv, state

    @jax.jit
    def r_shared(sp, x, ck, cv, pos):
        h = r_layers.rmsnorm(x, sp["ln1"], eps)
        a, ck, cv = r_layers.attention_decode(sp["attn"], h, ck, cv, pos,
                                              r_cfg)
        x = x + a
        h = r_layers.rmsnorm(x, sp["ln2"], eps)
        return x + r_layers.mlp(sp["mlp"], h, r_cfg), ck, cv

    b, s = toks.shape
    cache = p.model.init_cache(b, s)
    out = []
    for t in range(s):
        x = p.params["lm"]["embed"][torch.from_numpy(toks[:, t:t + 1])]
        for i in range(cfg.n_layers):
            want = r_layer(jax.tree.map(lambda a: a[i],
                                        p.r_params["layers"]),
                           _to_jax(x, dt), _to_jax(cache["conv"][i], dt),
                           _to_jax(cache["state"][i], jnp.float32))
            x = p.model._layer_decode(x, layer_params(p.params["layers"], i),
                                      cache, i)
            out.append((f"token {t} layer {i}", (
                x, cache["conv"][i].clone(), cache["state"][i].clone()), want))
            site = p.model.attn_site(i)
            if site is None:
                continue
            ck, cv = cache["attn_k"][site], cache["attn_v"][site]
            want = r_shared(p.r_params["shared"], _to_jax(x, dt),
                            _to_jax(ck, dt), _to_jax(cv, dt), jnp.int32(t))
            x = p.model._shared_block_decode(p.params["shared"], x, ck, cv,
                                             t)
            out.append((f"token {t} site {site}",
                        (x, ck.clone(), cv.clone()), want))
    return out


def test_bfloat16_blocks_match_jax():
    """Every block of the bfloat16 model, forward and decode, at 5e-2
    against the JAX package's on the same input."""
    p = pair(ARCH, "bfloat16")
    toks = tokens(p.cfg, s=16, seed=5)
    blocks = forward_blocks(p, toks)
    assert [name for name, _, _ in blocks] == [
        "layer 0", "site 0", "layer 1", "layer 2", "site 1", "layer 3"]
    steps = decode_blocks(p, toks[:, :6])
    assert len(steps) == 6 * 6
    for name, got, want in blocks + steps:
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            assert g.dtype == (torch.float32 if w.dtype == jnp.float32
                               else torch.bfloat16), name
            close(g, w, BF16_TOL)


def test_bfloat16_forward_and_decode_track_the_float32_model():
    """End to end in bfloat16: the port's logits lie no farther from the
    JAX package's float32 model on the same (bfloat16) weights than the
    JAX package's own bfloat16 logits do, plus 5e-2."""
    p = pair(ARCH, "bfloat16")
    r_cfg32 = dataclasses.replace(p.r_model.cfg, dtype=jnp.float32)
    r_model32 = r_build_model(r_cfg32, remat_policy="none")
    r_params32 = jax.tree.map(lambda a: a.astype(jnp.float32), p.r_params)
    toks = tokens(p.cfg, s=16, seed=5)
    truth = np.asarray(r_model32.forward_train(r_params32, jnp.asarray(toks)))
    theirs = as_f32(p.r_model.forward_train(p.r_params, jnp.asarray(toks)))
    mine = as_f32(p.model.forward_train(p.params, torch.from_numpy(toks)))
    assert np.abs(mine - truth).max() <= np.abs(theirs - truth).max() \
        + BF16_TOL
    want, got, _, _ = decode_both(p, toks[:, :6])
    r_cache = r_model32.init_cache(2, 6)
    truth = []
    for i in range(6):
        logits, r_cache = r_model32.forward_decode(
            r_params32, r_cache, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        truth.append(np.asarray(logits)[:, 0])
    truth = np.stack(truth)
    assert np.abs(got - truth).max() <= np.abs(want - truth).max() + BF16_TOL


def test_head_dim_112_matches_jax():
    """zamba2-7b's head dim on the reduced model: the plain attention path
    at D 112, in prefill and in decode."""
    p = pair(ARCH, replace=(("head_dim", 112),))
    assert p.cfg.hd == 112
    assert p.params["shared"]["attn"]["wq"].shape == (64, 4 * 112)
    toks = tokens(p.cfg, s=16, seed=6)
    close(p.model.forward_train(p.params, torch.from_numpy(toks)),
          p.r_model.forward_train(p.r_params, jnp.asarray(toks)), F32_TOL)
    want, got, r_cache, cache = decode_both(p, toks[:, :5])
    close(got, want, F32_TOL)
    close(cache["attn_v"], r_cache["attn_v"], F32_TOL)


def test_init_matches_the_reference_layout():
    p = pair(ARCH, "bfloat16")
    params = p.model.init(torch.Generator().manual_seed(0))
    mine = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), params)
    theirs = jax.tree.map(lambda a: (a.shape, jnp.dtype(a.dtype).name),
                          p.r_params)
    assert mine == theirs
    assert set(params["shared"]) == {"attn", "mlp", "ln1", "ln2"}
    assert params["shared"]["attn"]["wq"].dim() == 2     # not stacked


def test_carry_over_takes_the_shared_tree():
    """``params_from_numpy`` copies the unstacked ``shared`` tree bit for
    bit, keeps Mamba's float32 leaves, and still refuses a dtype that is
    not the config's."""
    p = pair(ARCH, "bfloat16")
    tree = jax.tree.map(np.asarray, p.r_params)
    for path, want in (("attn/wq", tree["shared"]["attn"]["wq"]),
                       ("mlp/w_down", tree["shared"]["mlp"]["w_down"]),
                       ("ln2", tree["shared"]["ln2"])):
        node = p.params["shared"]
        for key in path.split("/"):
            node = node[key]
        assert node.dtype == torch.bfloat16
        assert np.array_equal(node.view(torch.int16).numpy(),
                              want.view(np.int16))
    assert p.params["layers"]["mamba"]["A_log"].dtype == torch.float32
    bad = dict(tree, shared=dict(tree["shared"],
                                 ln1=np.ones(64, np.float32)))
    with pytest.raises(ValueError, match="shared/ln1.*config says"):
        params_from_numpy(bad, p.cfg)


def test_forward_refuses_input_embeds_and_ragged_chunks():
    p = pair(ARCH)
    toks = torch.from_numpy(tokens(p.cfg, s=8))
    with pytest.raises(ValueError, match="no frontend"):
        p.model.forward_train(p.params, toks, torch.zeros(2, 1, 64))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        p.model.forward_train(p.params, toks[:, :6])
    with pytest.raises(ValueError, match="ssd_dtype"):
        build_model(p.cfg, ssd_dtype="f16")


# ---------------------------------------------------------------- on a card
def card_blocks(p, on_card, toks, n_decode: int):
    """The bfloat16 model block by block, forward over ``toks`` and then
    decode over its first ``n_decode`` tokens, each block run on the card
    (the kernels) and on the CPU (the plain versions) on the CPU's input
    to it and, in decode, the CPU's cache entries before it → [(block, card
    outputs, CPU outputs)]; a decode block's outputs include its updated
    conv window and state, or its site's KV."""
    def card(t):
        return t.to("cuda", copy=True)

    s = toks.shape[1]
    x = p.params["lm"]["embed"][torch.from_numpy(toks)]
    pos = torch.arange(s)
    out = []
    for i in range(p.cfg.n_layers):
        got = p.model._layer_train(card(x), layer_params(on_card["layers"], i))
        x = p.model._layer_train(x, layer_params(p.params["layers"], i))
        out.append((f"layer {i}", (got,), (x,)))
        site = p.model.attn_site(i)
        if site is not None:
            got = p.model._shared_block(on_card["shared"], card(x), card(pos))
            x = p.model._shared_block(p.params["shared"], x, pos)
            out.append((f"site {site}", (got,), (x,)))
    cache = p.model.init_cache(toks.shape[0], n_decode)
    for t in range(n_decode):
        x = p.params["lm"]["embed"][torch.from_numpy(toks[:, t:t + 1])]
        for i in range(p.cfg.n_layers):
            c = {key: card(cache[key]) for key in ("conv", "state")}
            got = p.model._layer_decode(card(x), layer_params(
                on_card["layers"], i), c, i)
            x = p.model._layer_decode(x, layer_params(p.params["layers"], i),
                                      cache, i)
            out.append((f"token {t} layer {i}",
                        (got, c["conv"][i], c["state"][i]),
                        (x, cache["conv"][i].clone(),
                         cache["state"][i].clone())))
            site = p.model.attn_site(i)
            if site is None:
                continue
            ck, cv = cache["attn_k"][site], cache["attn_v"][site]
            gk, gv = card(ck), card(cv)
            got = p.model._shared_block_decode(on_card["shared"], card(x), gk,
                                               gv, t)
            x = p.model._shared_block_decode(p.params["shared"], x, ck, cv, t)
            out.append((f"token {t} site {site}", (got, gk, gv),
                        (x, ck.clone(), cv.clone())))
    return out


@gpu
@pytest.mark.parametrize("head_dim", [16, 112])
def test_kernel_path_matches_the_plain_path_on_the_card(head_dim):
    """Reduced zamba2 in bfloat16 on the card: a prefill step launches
    flash attention once a site (at D 112 on the tensor-core route) and
    RMSNorm for every norm.  As the CPU bfloat16 tests are stated: every
    block, forward and decode, on the card within 5e-2 of the CPU's plain
    path on the same input; end to end, the card's prefill and decode
    logits no farther from the float32 model on the same weights than the
    CPU's plain path's, plus 5e-2 (over the stack of six blocks the two
    drift apart by about a bfloat16 rounding a block)."""
    p = pair(ARCH, "bfloat16", replace=(("head_dim", head_dim),))
    on_card = jax.tree.map(lambda t: t.to("cuda"), p.params)
    toks = tokens(p.cfg, s=16, seed=7)
    step = make_prefill_step(p.model)
    fa_before = dict(fa_kernel.flash_attention.launches_by_route)
    rn_before = rn_kernel.rmsnorm.launches
    got = step(on_card, {"tokens": torch.from_numpy(toks).to("cuda")})
    route = fa_kernel.route(torch.bfloat16, head_dim)
    assert fa_kernel.flash_attention.launches_by_route[route] \
        == fa_before[route] + 2
    n_norm = 2 * p.cfg.n_layers + 2 * 2 + 1
    assert rn_kernel.rmsnorm.launches == rn_before + n_norm

    errs = {}
    for name, g, w in card_blocks(p, on_card, toks, 4):
        errs[name] = max(float(np.abs(as_f32(a) - as_f32(b)).max())
                         for a, b in zip(g, w))
    print(f"D {head_dim}: max |card - CPU| per block, on the same input: "
          + ", ".join(f"{k} {v:.4g}" for k, v in errs.items()))
    assert max(errs.values()) <= BF16_TOL, errs

    r_cfg32 = dataclasses.replace(p.r_model.cfg, dtype=jnp.float32)
    r_model32 = r_build_model(r_cfg32, remat_policy="none")
    r_params32 = jax.tree.map(lambda a: a.astype(jnp.float32), p.r_params)
    truth = np.asarray(r_make_prefill_step(r_model32)(
        r_params32, {"tokens": jnp.asarray(toks)}), np.float32)
    mine = as_f32(got)
    cpu = as_f32(step(p.params, {"tokens": torch.from_numpy(toks)}))
    far = {"prefill": (np.abs(mine - truth).max(),
                       np.abs(cpu - truth).max())}
    cache = p.model.init_cache(2, 4, device="cuda")
    cpu_cache = p.model.init_cache(2, 4)
    r_cache = r_model32.init_cache(2, 4)
    mine, cpu, truth = [], [], []
    for i in range(4):
        tok = torch.from_numpy(toks[:, i:i + 1])
        logits, cache = p.model.forward_decode(on_card, cache,
                                               tok.to("cuda"), i)
        want, cpu_cache = p.model.forward_decode(p.params, cpu_cache, tok, i)
        r_logits, r_cache = r_model32.forward_decode(
            r_params32, r_cache, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        mine.append(as_f32(logits))
        cpu.append(as_f32(want))
        truth.append(np.asarray(r_logits, np.float32))
    mine, cpu, truth = (np.stack(a) for a in (mine, cpu, truth))
    far["decode"] = (np.abs(mine - truth).max(), np.abs(cpu - truth).max())
    print(f"D {head_dim}: max |logits - float32 model|, card and CPU: {far}")
    for what, (card_far, cpu_far) in far.items():
        assert card_far <= cpu_far + BF16_TOL, (what, card_far, cpu_far)
