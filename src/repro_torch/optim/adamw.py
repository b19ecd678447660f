"""AdamW with decoupled weight decay, global-norm clipping, and a
warmup+cosine schedule: ``repro/optim/adamw.py`` restated.

Not ``torch.optim.AdamW``, whose decay and bias correction differ from
the update here, ``p − lr·(m̂/(√n̂ + eps) + wd·p)`` with ``m̂ = μ/(1 − b1^t)``
and ``n̂ = ν/(1 − b2^t)``.  The schedule and the bias corrections are
float32 tensors on the parameters' device, as jnp computes them, not
Python doubles.  Optimizer state (μ, ν in float32, the step in int32)
mirrors the parameter tree.

Where the JAX package returns new arrays (and the launcher donates the old
ones), :func:`adamw_update` updates the parameters and the state IN PLACE,
one leaf at a time and each large leaf in slices, so its float32
temporaries are one slice's, never the whole tree's.

On DTensor leaves (a mesh with an axis above 1) each rank updates its own
shards in place; the gradients must already be in their parameters'
placements (``repro_torch.train.step``), and the global norm sums each
shard's squares once across the ranks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor, Shard

from repro_torch.models import common as dt
from repro_torch.models.common import leaves, tree_map

# elements of a leaf updated at once: the float32 temporaries of one slice
# are a few of 2^26 elements (256 MB each), whatever the leaf's size
SLICE = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    clip_norm: float = 1.0


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int32 tensor or an int) as a
    float32 tensor: linear warmup, then a cosine down to a tenth."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp((step + 1) / cfg.warmup_steps, max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def adamw_init(params) -> Dict[str, Any]:
    """μ and ν as float32 zeros beside each parameter, and step 0."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)
    first = leaves(params)[0]
    step = torch.zeros((), dtype=torch.int32, device=first.device)
    if isinstance(first, DTensor):
        step = dt.from_local(step, first.device_mesh,
                             dt.replicated(first.device_mesh))
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": step}


def _slices(t: torch.Tensor):
    flat = t.reshape(-1)
    return [flat[lo:lo + SLICE] for lo in range(0, flat.numel(), SLICE)]


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves (in :func:`leaves` order) of each leaf's
    sum of squares in float32, taken a slice at a time.  DTensor leaves:
    each rank sums its shards' squares, leaves sharded alike together, and
    each such sum is all-reduced over the mesh dimensions that shard them
    (a replicated leaf counts once) → the same plain tensor on every
    rank."""
    groups, mesh = {}, None
    for g in leaves(grads):
        dims = ()
        if isinstance(g, DTensor):
            mesh = g.device_mesh
            dims = tuple(i for i, p in enumerate(g.placements)
                         if isinstance(p, Shard))
        groups[dims] = groups.get(dims, 0) + sum(
            torch.sum(torch.square(s.float())) for s in _slices(dt.local(g)))
    total = 0
    for dims in sorted(groups):
        total = total + dt.all_reduce(groups[dims], mesh, dims)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads, max_norm: float):
    """→ (every gradient in float32 scaled so that the global norm is at
    most ``max_norm``, the global norm before scaling)."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), gn


def adamw_update(cfg: AdamWConfig, params, grads, state
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, Any]]:
    """One clipped AdamW step → (params, state, metrics), the first two
    the same trees updated in place.  ``grads`` mirrors ``params`` (any
    floating dtype); metrics hold ``lr``, ``grad_norm`` and ``step`` as
    tensors on the parameters' device."""
    gn = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gn + 1e-9), max=1.0)
    step = dt.local(state["step"]) + 1
    lr = lr_schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    with torch.no_grad():
        for p, g, mu, nu in zip(leaves(params), leaves(grads),
                                leaves(state["mu"]), leaves(state["nu"])):
            leaf = [dt.local(t) for t in (p, g, mu, nu)]
            for ps, gs, ms, ns in zip(*map(_slices, leaf)):
                _update(cfg, ps, gs, ms, ns, scale, lr, b1c, b2c)
    old = state["step"]
    state["step"] = (dt.from_local(step, old.device_mesh, old.placements)
                     if isinstance(old, DTensor) else step)
    return params, state, {"lr": lr, "grad_norm": gn, "step": step}


def _update(cfg: AdamWConfig, p, g, mu, nu, scale, lr, b1c, b2c) -> None:
    """The reference's ``upd`` on one slice, written into p, mu and nu:
    mu = b1·mu + (1−b1)·g, nu = b2·nu + (1−b2)·g·g,
    p = p − lr·(mu/b1c / (sqrt(nu/b2c) + eps) + wd·p)."""
    gf = g.float() * scale
    mu.mul_(cfg.b1).add_(gf * (1 - cfg.b1))
    nu.mul_(cfg.b2).add_(gf * (1 - cfg.b2) * gf)
    del gf
    upd = mu / b1c
    upd.div_((nu / b2c).sqrt_().add_(cfg.eps))
    pf = p.float()
    upd.add_(pf * cfg.weight_decay)
    p.copy_(pf.sub_(upd.mul_(lr)))
