"""The port's MoE family against the JAX package.

Reduced mixtral-8x22b (sliding window 16) and qwen3-moe-235b-a22b
(``qk_norm``), with the JAX parameters carried across by
``params_from_numpy`` (the router stays float32) and the same token ids
through both.  Float32 at 1e-4 (the same operations, sums in another
order), bfloat16 at 5e-2 (XLA and torch round bfloat16 intermediates at
different places).  Random float32 router weights give no ties in the
top-k.  On the CPU every kernel call takes its plain version; the ``gpu``
tests run the kernel path on a card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as r_moe
from repro.train.step import make_prefill_step as r_make_prefill_step
from repro_torch.configs import registry as configs
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.rmsnorm import kernel as rn_kernel
from repro_torch.models import moe
from repro_torch.models.common import params_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.train.step import make_prefill_step
from torch_model_pair import (BF16_TOL, F32_TOL, close, decode_both, pair,
                              tokens)

ARCHS = ["mixtral-8x22b", "qwen3-moe-235b-a22b"]
# the capacity factor at which no token drops in either mode: capacity is
# G*k/E*factor, and E/k is 2 in both reduced configs
NO_DROP = (("capacity_factor", 16.0),)


def gpu(fn):
    """Needs a CUDA card: decided when the test runs, not at import."""
    fn = pytest.mark.skipif("not torch.cuda.is_available()",
                            reason="needs a CUDA card")(fn)
    return pytest.mark.gpu(fn)


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_jax(arch, grouped):
    p = pair(arch, moe_grouped=grouped)
    assert p.model.moe_grouped is grouped
    toks = tokens(p.cfg, s=24)            # longer than mixtral's window
    want = p.r_model.forward_train(p.r_params, jnp.asarray(toks))
    got = p.model.forward_train(p.params, torch.from_numpy(toks))
    assert got.shape == (2, 24, p.cfg.vocab_padded)
    close(got, want, F32_TOL)
    want = r_make_prefill_step(p.r_model)(p.r_params,
                                          {"tokens": jnp.asarray(toks)})
    got = make_prefill_step(p.model)(p.params,
                                     {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, p.cfg.vocab_padded)
    close(got, want, F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch):
    p = pair(arch)
    toks = tokens(p.cfg, s=20, seed=1)
    want, got, r_cache, cache = decode_both(p, toks)
    close(got, want, F32_TOL)
    close(cache["k"], r_cache["k"], F32_TOL)
    close(cache["v"], r_cache["v"], F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward_when_nothing_drops(arch):
    """Capacity is per dispatch group (B*S tokens in forward, B in
    decode), so the two modes agree only where no token drops."""
    p = pair(arch, replace=NO_DROP)
    toks = tokens(p.cfg, b=1, s=12, seed=2)
    want = p.model.forward_train(p.params, torch.from_numpy(toks))
    _, got, _, _ = decode_both(p, toks)
    close(got.transpose(1, 0, 2), want, F32_TOL)


def test_capacity_drops_match_jax():
    """``tests/test_models.py::test_moe_capacity_drops_tokens_gracefully``'s
    case, factor 0.5, held against the JAX logits; tokens do drop."""
    p = pair("qwen3-moe-235b-a22b", replace=(("capacity_factor", 0.5),))
    toks = tokens(p.cfg, s=16, seed=3)
    got = p.model.forward_train(p.params, torch.from_numpy(toks))
    assert bool(torch.isfinite(got).all())
    close(got, p.r_model.forward_train(p.r_params, jnp.asarray(toks)),
          F32_TOL)
    # 32 tokens x 2 choices over 4 experts of capacity 8: at least half
    # drop, so the logits differ from those at a factor where none does
    roomy = pair("qwen3-moe-235b-a22b", replace=NO_DROP)
    assert not torch.allclose(
        got, roomy.model.forward_train(roomy.params, torch.from_numpy(toks)),
        atol=1e-2)


@pytest.mark.parametrize("factor", [0.5, 1.25, 16.0])
@pytest.mark.parametrize("grouped", [False, True])
def test_dispatch_matches_jax_on_its_own(grouped, factor):
    """One MoE layer's dispatch, expert FFN and combine on random inputs,
    one global group or one group per row, with and without drops."""
    p = pair("qwen3-moe-235b-a22b")
    cfg = dataclasses.replace(p.cfg, capacity_factor=factor)
    r_cfg = dataclasses.replace(p.r_model.cfg, capacity_factor=factor)
    r_lp = jax.tree.map(lambda a: a[0], p.r_params["layers"]["moe"])
    lp = {k: v[0] for k, v in p.params["layers"]["moe"].items()}
    x = np.random.default_rng(4).standard_normal(
        (3, 10, cfg.d_model)).astype(np.float32)
    want = r_moe.moe_mlp(r_lp, jnp.asarray(x), r_cfg, grouped=grouped)
    got = moe.moe_mlp(lp, torch.from_numpy(x), cfg, grouped=grouped)
    assert got.shape == x.shape
    close(got, want, F32_TOL)


def test_bfloat16_forward_and_decode_match_jax():
    p = pair("qwen3-moe-235b-a22b", "bfloat16")
    assert p.params["layers"]["moe"]["router"].dtype == torch.float32
    assert p.params["layers"]["moe"]["w_up"].dtype == torch.bfloat16
    toks = tokens(p.cfg, s=8, seed=5)
    close(p.model.forward_train(p.params, torch.from_numpy(toks)),
          p.r_model.forward_train(p.r_params, jnp.asarray(toks)), BF16_TOL)
    want, got, _, _ = decode_both(p, toks[:, :4])
    close(got, want, BF16_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_layout_and_dtypes_match_the_reference(arch):
    p = pair(arch, "bfloat16")
    params = p.model.init(torch.Generator().manual_seed(0))

    def flat(tree, name):
        return {"/".join(str(k.key) for k in path): (tuple(leaf.shape),
                                                     name(leaf.dtype))
                for path, leaf in jax.tree_util.tree_flatten_with_path(
                    tree)[0]}
    mine = flat(params, lambda dt: str(dt).removeprefix("torch."))
    theirs = flat(p.r_params, lambda dt: jnp.dtype(dt).name)
    assert mine == theirs
    assert mine["layers/moe/router"][1] == "float32"
    # the experts are scaled by their input width, as the reference's are
    w_up = params["layers"]["moe"]["w_up"].float()
    assert abs(float(w_up.std()) * p.cfg.d_model ** 0.5 - 1.0) < 0.1


def test_params_from_numpy_keeps_the_float32_leaves():
    """In a bfloat16 config the router, A_log, D and dt_bias must be
    float32; every other floating leaf must be bfloat16."""
    cfg = configs.get_arch("qwen3-moe-235b-a22b")
    bf16 = np.asarray(jnp.zeros(3, jnp.bfloat16))
    f32 = np.zeros(3, np.float32)
    tree = {"moe": {"router": f32, "w_up": bf16},
            "mamba": {"A_log": f32, "D": f32, "dt_bias": f32,
                      "norm": bf16}}
    out = params_from_numpy(tree, cfg)
    assert out["moe"]["router"].dtype == torch.float32
    assert out["mamba"]["D"].dtype == torch.float32
    assert out["mamba"]["norm"].dtype == torch.bfloat16
    for leaf in ("router", "A_log", "D", "dt_bias"):
        with pytest.raises(ValueError, match="must be float32"):
            params_from_numpy({"x": {leaf: bf16}}, cfg)
    for leaf in ("w_up", "norm", "routers", "d"):
        with pytest.raises(ValueError, match="config says"):
            params_from_numpy({"x": {leaf: f32}}, cfg)


# ---------------------------------------------------------------- on a card
@gpu
def test_kernel_path_matches_the_plain_path_on_the_card():
    """Reduced qwen3-moe in bfloat16 on the card: prefill and decode
    launch the kernels, agree with the plain path on the CPU within the
    bfloat16 tolerance, and repeat bit for bit (the combine has no atomic
    adds)."""
    p = pair("qwen3-moe-235b-a22b", "bfloat16")
    on_card = jax.tree.map(lambda t: t.to("cuda"), p.params)
    toks = tokens(p.cfg, s=16, seed=6)
    step = make_prefill_step(p.model)
    fa_before, rn_before = (fa_kernel.flash_attention.launches,
                            rn_kernel.rmsnorm.launches)
    got = step(on_card, {"tokens": torch.from_numpy(toks).to("cuda")})
    assert fa_kernel.flash_attention.launches == fa_before + 2
    assert rn_kernel.rmsnorm.launches == rn_before + 4 * 2 + 1
    again = step(on_card, {"tokens": torch.from_numpy(toks).to("cuda")})
    assert torch.equal(got, again)
    want = step(p.params, {"tokens": torch.from_numpy(toks)})
    close(got, want, BF16_TOL)
    plain = build_model(p.cfg, attn_impl="ref")
    close(got, make_prefill_step(plain)(
        on_card, {"tokens": torch.from_numpy(toks).to("cuda")}), BF16_TOL)
