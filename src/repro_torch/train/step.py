"""train_step / prefill_step / serve_step builders: the units the
launchers drive.

The train step is ``repro/train/step.py``'s: the loss and its gradients
(``torch.autograd.grad`` over the parameter leaves), optionally summed in
bfloat16 over microbatches, then one clipped AdamW update, applied IN
PLACE (the port's counterpart of the JAX launcher's donated state).  The
prefill and serve steps run under ``torch.inference_mode()``.
``state_specs`` gives the train state's sharding specs.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

from repro_torch.models.common import (STACKED, P, leaves, tree_map,
                                       unflatten)
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update


def _batch_on(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """numpy arrays (or tensors) of a batch as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _split(node, stacked: bool, slots: List) -> Any:
    """``node`` with each leaf replaced by a detached view that requires
    grad (a list of per-layer views where ``stacked``), each leaf's views
    appended to ``slots``.  A module function, not a closure: a recursive
    closure is a reference cycle, which would keep ``slots`` (and through
    it the parameters' storage) alive until the cycle collector runs."""
    if isinstance(node, dict):
        return {k: _split(node[k], stacked, slots) for k in sorted(node)}
    views = ([node[i].detach().requires_grad_() for i in range(node.shape[0])]
             if stacked else [node.detach().requires_grad_()])
    slots.append((views, stacked))
    return views if stacked else views[0]


def value_and_grad(model, params, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """→ (``model.loss(params, batch)``, its gradient with respect to every
    parameter, in the parameters' layout and dtypes).

    The model sees detached copies of the leaves that require grad (views
    of the same storage, so nothing is copied), and each stacked leaf (a
    subtree named in ``STACKED``) as a list of per-layer views: autograd
    through ``stacked[i]`` would allocate the whole stack for every layer's
    gradient.  The per-layer gradients are stacked back at the end; a
    parameter the loss does not reach gets zeros, as ``jax.grad`` gives."""
    slots: List[Tuple[List[torch.Tensor], bool]] = []
    tree = {k: _split(params[k], k in STACKED, slots) for k in sorted(params)}
    with torch.enable_grad():
        loss = model.loss(tree, batch)
        flat = [t for views, _ in slots for t in views]
        grads = list(torch.autograd.grad(loss, flat, allow_unused=True))
    out, i = [], 0
    for views, stacked in slots:
        gs = [g if g is not None else torch.zeros_like(t)
              for g, t in zip(grads[i:i + len(views)], views)]
        grads[i:i + len(views)] = [None] * len(views)   # freed once stacked
        i += len(views)
        out.append(torch.stack(gs) if stacked else gs[0])
    return loss.detach(), unflatten(params, out)


def make_train_step(model, opt_cfg: AdamWConfig,
                    grad_accum: int = 1) -> Callable:
    """(state, batch) → (state, metrics); state = {params, opt}, updated in
    place; metrics hold ``loss``, ``grad_norm``, ``lr`` and ``step`` as
    tensors on the parameters' device.  The batch (numpy arrays or
    tensors) goes to that device here.

    grad_accum > 1: the batch is split into ``grad_accum`` microbatches
    run one after another, their gradients summed in bfloat16 whatever the
    parameters' dtype (as the JAX package's ``g0`` does) and divided by
    ``grad_accum``: peak activation memory divides by ``grad_accum``."""

    def train_step(state: Dict[str, Any], batch: Dict[str, Any]):
        params = state["params"]
        batch = _batch_on(batch, leaves(params)[0].device)
        if grad_accum == 1:
            loss, grads = value_and_grad(model, params, batch)
        else:
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.bfloat16, device=p.device), params)
            loss = 0.0
            for i in range(grad_accum):
                micro = {k: v.reshape(grad_accum, v.shape[0] // grad_accum,
                                      *v.shape[1:])[i]
                         for k, v in batch.items()}
                lval, g = value_and_grad(model, params, micro)
                for a, b in zip(leaves(grads), leaves(g)):
                    a.add_(b.to(a.dtype))
                del g
                loss = loss + lval
            loss = loss / grad_accum
            grads = tree_map(lambda g: g / grad_accum, grads)
        params, opt, metrics = adamw_update(opt_cfg, params, grads,
                                            state["opt"])
        metrics = {**metrics, "loss": loss}
        return {"params": params, "opt": opt}, metrics

    return train_step


def make_prefill_step(model) -> Callable:
    """Forward-only full-sequence step (inference prefill): returns logits
    of the last position (next-token), (B, V)."""

    @torch.inference_mode()
    def prefill_step(params, batch: Dict[str, Any]) -> torch.Tensor:
        # last_only: the (B, S, V) logits tensor is never materialised —
        # only the final position is unembedded
        logits = model.forward_train(params, batch["tokens"],
                                     batch.get("input_embeds"),
                                     last_only=True)
        return logits[:, -1]

    return prefill_step


def make_serve_step(model) -> Callable:
    """(params, cache, tokens, cur_pos) → (next_logits (B, V), cache); the
    cache is updated in place."""

    @torch.inference_mode()
    def serve_step(params, cache, tokens: torch.Tensor, cur_pos: int):
        logits, cache = model.forward_decode(params, cache, tokens, cur_pos)
        return logits[:, -1], cache

    return serve_step


def init_state(model, gen: torch.Generator,
               opt: bool = True) -> Dict[str, Any]:
    """Parameters drawn from ``gen`` (on its device), with AdamW's state
    beside them unless ``opt`` is False."""
    params = model.init(gen)
    if not opt:
        return {"params": params}
    return {"params": params, "opt": adamw_init(params)}


def state_specs(model, multi_pod: bool = False) -> Dict[str, Any]:
    """The sharding specs of :func:`init_state`'s tree: the optimizer's
    moments as the parameters, its step replicated."""
    ps = model.param_specs(multi_pod)
    return {"params": ps, "opt": {"mu": ps, "nu": ps, "step": P()}}
