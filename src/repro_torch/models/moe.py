"""Mixture-of-Experts transformer (mixtral-8x22b, qwen3-moe-235b-a22b).

Dispatch is capacity-based (GShard-style) and index-based, as in the JAX
package: tokens are ranked into per-expert slots with a cumsum, written
into an (E, C, d) buffer, run through the expert FFNs as batched matrix
products, and combined back weighted by their router probabilities.
Tokens past an expert's capacity are dropped (standard capacity_factor
semantics).

Both scatters are deterministic.  The dispatch writes each kept row to its
own slot (dropped rows go to one spare row that is thrown away), which is
what the JAX package's scatter-add of zero rows leaves in the buffer.  The
combine sums each token's ``top_k`` contributions along an axis, never
with atomic adds, whose bfloat16 sums would change order from run to run.
No step reads a mask back to the host.

Expert parallelism (the JAX package's ``moe_specs``) waits for the
sharding item of ``ROADMAP.md``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.common import ArchConfig, dense_init
from repro_torch.models.transformer import DenseLM


def init_moe_mlp(gen: torch.Generator, cfg: ArchConfig, device=None,
                 n_stack: int = 0) -> Dict[str, torch.Tensor]:
    """The router stays float32 whatever ``cfg.dtype`` is; the expert
    weights are expert-major, scaled by their input width."""
    d, ff, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    kw = dict(dtype=cfg.dtype, device=device, n_stack=n_stack, scale_axis=1)
    return {
        "router": dense_init(gen, (d, e), dtype=torch.float32, device=device,
                             n_stack=n_stack),
        "w_gate": dense_init(gen, (e, d, ff), **kw),
        "w_up": dense_init(gen, (e, d, ff), **kw),
        "w_down": dense_init(gen, (e, ff, d), **kw),
    }


def _dispatch_groups(xg: torch.Tensor, p: Dict[str, torch.Tensor],
                     cfg: ArchConfig) -> torch.Tensor:
    """``n`` dispatch groups at once: xg (n, G, d) → (n, G, d).  Capacity
    is per group, as in the JAX package's ``_dispatch_group``; the groups
    share one expert buffer, group i owning slots [i*C, (i+1)*C) of every
    expert."""
    n, g, d = xg.shape
    k, e = cfg.top_k, cfg.n_experts
    cap = int(max(1, g * k / e * cfg.capacity_factor))

    probs = torch.softmax(xg.float() @ p["router"], dim=-1)    # (n, G, E)
    w, idx = torch.topk(probs, k, dim=-1, sorted=True)          # (n, G, k)
    w = (w / w.sum(-1, keepdim=True)).to(xg.dtype)

    fe = idx.reshape(n, g * k)                                  # (n, G*k)
    # rank within expert: a cumsum over the one-hot, laid out (n, E, G*k)
    # so that the scan runs along the contiguous axis (along a strided
    # one, torch's scan took 51 ms a layer at G*k = 131072 on an H100)
    experts = torch.arange(e, device=xg.device, dtype=fe.dtype)
    onehot = (fe[:, None, :] == experts[:, None]).to(torch.int32)
    ranks = onehot.cumsum(2, dtype=torch.int32) - onehot
    slot = ranks.gather(1, fe[:, None, :])[:, 0].long()
    keep = slot < cap
    slot_c = torch.where(keep, slot, cap - 1)
    # row of (expert, group, slot) in the (E * n * C, d) buffer
    group = torch.arange(n, device=xg.device)[:, None] * cap
    row = (fe * (n * cap) + group + slot_c).reshape(-1)
    spare = e * n * cap                       # where dropped rows are written
    buf = xg.new_zeros((spare + 1, d))
    buf[torch.where(keep.reshape(-1), row, spare)] = \
        xg.repeat_interleave(k, dim=1).reshape(-1, d)
    buf = buf[:spare].view(e, n * cap, d)

    # expert FFN as batched products over the expert axis; each buffer is
    # dropped as soon as it is used (at qwen3-moe's prefill each is 0.5 to
    # 1.3 GB, and together they set the peak)
    up = torch.bmm(buf, p["w_up"])
    act = F.silu(torch.bmm(buf, p["w_gate"]).float()).to(xg.dtype).mul_(up)
    del buf, up
    y = torch.bmm(act, p["w_down"]).view(spare, d)              # (E*n*C, d)
    del act

    y_tok = y[row].mul_((w.reshape(-1)
                         * keep.reshape(-1).to(xg.dtype))[:, None])
    del y
    return y_tok.view(n, g, k, d).sum(2)


def moe_mlp(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ArchConfig,
            grouped: bool = False) -> torch.Tensor:
    """x: (B, S, d) → (B, S, d).

    grouped=False: one global dispatch group (capacity pooled over the
    whole batch).  grouped=True: one dispatch group per sequence (batch
    row), each with its own capacity."""
    b, s, d = x.shape
    if grouped:
        return _dispatch_groups(x, p, cfg)
    return _dispatch_groups(x.reshape(1, b * s, d), p, cfg).view(b, s, d)


class MoeLM(DenseLM):
    """DenseLM with the FFN swapped for the MoE dispatcher.  Decode
    dispatches the batch's tokens as one global group, as the JAX package
    does, whatever ``moe_grouped`` says."""

    def __init__(self, cfg: ArchConfig, attn_impl=None,
                 moe_grouped: bool = False, remat_policy: str = "full"):
        super().__init__(cfg, attn_impl=attn_impl, remat_policy=remat_policy)
        self.moe_grouped = moe_grouped

    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        """Random parameters drawn from ``gen``, on ``gen``'s device."""
        cfg, dev = self.cfg, gen.device
        n = cfg.n_layers
        lm = L.init_lm(gen, cfg, device=dev)
        layers = {
            "attn": L.init_attention(gen, cfg, device=dev, n_stack=n),
            "moe": init_moe_mlp(gen, cfg, device=dev, n_stack=n),
            "ln1": torch.ones((n, cfg.d_model), dtype=cfg.dtype, device=dev),
            "ln2": torch.ones((n, cfg.d_model), dtype=cfg.dtype, device=dev),
        }
        return {"lm": lm, "layers": layers}

    def _layer_train(self, x, lp, pos):
        cfg = self.cfg
        h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        x = x + L.attention(lp["attn"], h, cfg, pos=pos,
                            attn_impl=self.attn_impl)
        h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
        return x + moe_mlp(lp["moe"], h, cfg, grouped=self.moe_grouped)

    def _layer_decode(self, x, lp, cache_k, cache_v, cur_pos: int):
        cfg = self.cfg
        h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        a, _, _ = L.attention_decode(lp["attn"], h, cache_k, cache_v,
                                     cur_pos, cfg)
        x = x + a
        h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
        return x + moe_mlp(lp["moe"], h, cfg)
