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

:func:`moe_specs` gives the reference's expert parallelism as data:
experts over 'model' where they divide it, else each expert's FFN width.
On DTensors (:func:`moe_mlp`) every rank routes all of its tokens, which
are replicated over 'model', identically, and runs the batched products of
its own experts (or its own FFN columns of every expert); each rank's
combine is a partial sum, all-reduced.  No expert weight moves.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Shard

from repro_torch.models import common as dt
from repro_torch.models import layers as L
from repro_torch.models.common import (ArchConfig, P, dense_init, spec,
                                       stack_spec)
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
                     cfg: ArchConfig, e0: int = 0,
                     spread=None) -> torch.Tensor:
    """``n`` dispatch groups at once: xg (n, G, d) → (n, G, d).  Capacity
    is per group, as in the JAX package's ``_dispatch_group``; the groups
    share one expert buffer, group i owning slots [i*C, (i+1)*C) of every
    expert.

    ``p``'s expert weights may hold experts ``e0`` onwards only (one
    rank's experts): the routing is over all ``cfg.n_experts``, the
    products over those held, and the result is their share.

    ``spread`` (mesh, dims): each group's tokens continue on the ranks of
    those mesh dimensions (a batch sharded on 'data' dispatched as one
    group): the capacity is the whole group's, and each token's rank
    within its expert counts the tokens of the ranks before this one."""
    n, g, d = xg.shape
    k, e = cfg.top_k, cfg.n_experts
    el = p["w_up"].shape[0]                     # the experts held here
    ranks_before = 1
    if spread is not None:
        ranks_before = math.prod(spread[0].size(i) for i in spread[1])
    cap = int(max(1, g * ranks_before * k / e * cfg.capacity_factor))

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
    if spread is not None:
        ranks += _tokens_before(onehot.sum(2, dtype=torch.int32),
                                *spread)[:, :, None]
    slot = ranks.gather(1, fe[:, None, :])[:, 0].long()
    keep = slot < cap
    slot_c = torch.where(keep, slot, cap - 1)
    if el != e:                                 # another rank's experts
        keep &= (fe >= e0) & (fe < e0 + el)
    # row of (expert, group, slot) in the (E * n * C, d) buffer
    group = torch.arange(n, device=xg.device)[:, None] * cap
    row = ((fe - e0) * (n * cap) + group + slot_c).reshape(-1)
    spare = el * n * cap                      # where dropped rows are written
    buf = xg.new_zeros((spare + 1, d))
    buf[torch.where(keep.reshape(-1), row, spare)] = \
        xg.repeat_interleave(k, dim=1).reshape(-1, d)
    buf = buf[:spare].view(el, n * cap, d)
    if el != e:
        row = torch.where(keep.reshape(-1), row, 0)

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


def _tokens_before(counts: torch.Tensor, mesh, dims) -> torch.Tensor:
    """counts (n, E): this rank's tokens per expert → the tokens per expert
    of the ranks before it along mesh dimensions ``dims`` (gathered)."""
    pl = dt.with_placement(dt.replicated(mesh), dims, Shard(0))
    every = dt.gather(dt.from_local(counts[None], mesh, pl), 0).to_local()
    me = 0
    for i in dims:
        me = me * mesh.size(i) + mesh.get_local_rank(i)
    return every[:me].sum(0, dtype=torch.int32)


def moe_mlp(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ArchConfig,
            grouped: bool = False) -> torch.Tensor:
    """x: (B, S, d) → (B, S, d).

    grouped=False: one global dispatch group (capacity pooled over the
    whole batch).  grouped=True: one dispatch group per sequence (batch
    row), each with its own capacity."""
    if isinstance(x, DTensor):
        return _sharded_moe(p, x, cfg, grouped)
    return _moe_local(p, x, cfg, grouped)


def _moe_local(p, x, cfg: ArchConfig, grouped: bool, e0: int = 0,
               spread=None):
    b, s, d = x.shape
    if grouped:
        return _dispatch_groups(x, p, cfg, e0)
    return _dispatch_groups(x.reshape(1, b * s, d), p, cfg, e0,
                            spread).view(b, s, d)


def _sharded_moe(p, x: DTensor, cfg: ArchConfig, grouped: bool) -> DTensor:
    """The MoE FFN on each rank's experts (or FFN columns): x (B, S, d) is
    replicated on 'model'; each rank's output, and its gradients of x and
    the router, are partial sums over 'model'.  Ungrouped, a batch sharded
    on 'data' is still one dispatch group, as on one rank."""
    mesh = x.device_mesh
    batch_dims = dt.mesh_dims(x, 0)
    spread = (mesh, batch_dims) if batch_dims and not grouped else None
    dims = dt.mesh_dims(p["w_up"], 0) + dt.mesh_dims(p["w_up"], 2)
    partial = dt.with_placement(x.placements, dims, Partial())
    lp = {}
    for name, w in p.items():
        grad = dt.weight_grad(w, x)
        if name == "router":
            grad = dt.with_placement(grad, dims, Partial())
        lp[name] = w.to_local(grad_placements=grad)
    xl = x.to_local(grad_placements=partial)
    y = _moe_local(lp, xl, cfg, grouped, e0=dt.offset(p["w_up"], 0),
                   spread=spread)
    return dt.reduce(dt.from_local(y, mesh, partial))


def moe_specs(cfg: ArchConfig, multi_pod: bool = False) -> Dict[str, Any]:
    """Expert weights: EP over 'model' if divisible, else TP-in-expert."""
    model_size_hint = 16
    if cfg.n_experts % model_size_hint == 0:
        wg = wd = P("model", None, None)
    else:
        wg, wd = P(None, None, "model"), P(None, "model", None)
    return {"router": P(None, None), "w_gate": wg, "w_up": wg, "w_down": wd}


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

    def param_specs(self, multi_pod: bool = False) -> Dict[str, Any]:
        """The sharding specs of :meth:`init`'s tree."""
        layer = {"attn": L.attention_specs(self.cfg, multi_pod),
                 "moe": moe_specs(self.cfg, multi_pod),
                 "ln1": spec(None), "ln2": spec(None)}
        return {"lm": L.lm_specs(multi_pod), "layers": stack_spec(layer)}

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
