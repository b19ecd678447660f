"""train_step / prefill_step / serve_step builders: the units the
launchers drive.

The train step is ``repro/train/step.py``'s: the loss and its gradients
(``torch.autograd.grad`` over the parameter leaves), optionally summed in
bfloat16 over microbatches, then one clipped AdamW update, applied IN
PLACE (the port's counterpart of the JAX launcher's donated state).  The
prefill and serve steps run under ``torch.inference_mode()``.
``state_specs`` gives the train state's sharding specs.

On a mesh with an axis above 1 (DTensor parameters, see
:func:`repro_torch.launch.mesh.place`) the steps place their inputs by
``input_shardings`` (the batch on 'data'), and every gradient is
redistributed to its parameter's placements before the update: partial
sums over 'data', and over 'model' for the replicated leaves, are
all-reduced.  The layout needs no reduce-scatter.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models import common as dt
from repro_torch.models.common import (STACKED, P, leaves, tree_map,
                                       unflatten)
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update


def _batch_on(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """numpy arrays (or tensors) of a batch as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def place_inputs(model, params, batch: Dict[str, Any], kind: str
                 ) -> Dict[str, torch.Tensor]:
    """A batch (numpy arrays or tensors, whole on every rank) where the
    parameters are: on their device, or as DTensors placed by
    ``input_shardings(cfg, kind)`` beside DTensor parameters (over the
    'pod' axis too where the mesh has one; replicated where the batch does
    not divide the data axes)."""
    first = leaves(params)[0]
    if not isinstance(first, DTensor):
        return _batch_on(batch, first.device)
    from repro_torch.launch.mesh import axis_size, place
    from repro_torch.models.registry import input_shardings
    mesh = first.device_mesh
    multi_pod = "pod" in mesh.mesh_dim_names
    specs = input_shardings(model.cfg, kind, multi_pod)
    rows = next(iter(batch.values())).shape[0]
    if rows % math.prod(axis_size(mesh, a) for a in
                        (("pod", "data") if multi_pod else ("data",))):
        specs = {k: P() for k in specs}     # a thin batch (long_500k's 1)
    return place({k: v if isinstance(v, DTensor)
                  else torch.as_tensor(v).to(first.device)
                  for k, v in batch.items()},
                 {k: specs[k] for k in batch}, mesh)


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
    parameter, in the parameters' layout and dtypes; DTensor gradients in
    their parameters' placements).

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
    for (views, stacked), p in zip(slots, leaves(params)):
        gs = [_reduced(g, t) for g, t in zip(grads[i:i + len(views)], views)]
        grads[i:i + len(views)] = [None] * len(views)   # freed once stacked
        i += len(views)
        out.append(_stacked(gs, p) if stacked else gs[0])
    return loss.detach(), unflatten(params, out)


def _reduced(g, t):
    """The gradient ``g`` of view ``t`` (zeros where the loss does not
    reach it), a DTensor one redistributed to ``t``'s placements."""
    if g is None:
        return torch.zeros_like(t)
    if isinstance(g, DTensor) and g.placements != t.placements:
        return g.redistribute(t.device_mesh, t.placements)
    return g


def _stacked(gs, p):
    """Per-layer gradients stacked as the parameter ``p`` (a DTensor's
    shards stacked where they lie)."""
    if not isinstance(p, DTensor):
        return torch.stack(gs)
    return dt.from_local(torch.stack([g.to_local() for g in gs]),
                         p.device_mesh, p.placements)


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
        if grad_accum == 1:
            loss, grads = value_and_grad(
                model, params, place_inputs(model, params, batch, "train"))
        else:
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.bfloat16), params)
            loss = 0.0
            batch = {k: dt.full(v) if isinstance(v, DTensor)
                     else torch.as_tensor(v) for k, v in batch.items()}
            for i in range(grad_accum):
                micro = {k: v.reshape(grad_accum, v.shape[0] // grad_accum,
                                      *v.shape[1:])[i]
                         for k, v in batch.items()}
                lval, g = value_and_grad(
                    model, params, place_inputs(model, params, micro,
                                                "train"))
                for a, b in zip(leaves(grads), leaves(g)):
                    a.add_(b.to(a.dtype))
                del g
                loss = loss + lval
            loss = loss / grad_accum
            grads = tree_map(lambda g: g / grad_accum, grads)
        params, opt, metrics = adamw_update(opt_cfg, params, grads,
                                            state["opt"])
        metrics = {**metrics, "loss": dt.local(loss)}
        return {"params": params, "opt": opt}, metrics

    return train_step


def make_prefill_step(model) -> Callable:
    """Forward-only full-sequence step (inference prefill): returns logits
    of the last position (next-token), (B, V).  The tokens are placed as
    ever; where the model's ``act_sharding`` is set, the activations'
    sequence is sharded from the embedding output on (context-parallel
    prefill; the train and serve steps never read it)."""

    def prefill_step(params, batch: Dict[str, Any]) -> torch.Tensor:
        # last_only: the (B, S, V) logits tensor is never materialised —
        # only the final position is unembedded
        with inference(params):
            if isinstance(leaves(params)[0], DTensor):
                batch = place_inputs(model, params, batch, "prefill")
            logits = model.forward_train(params, batch["tokens"],
                                         batch.get("input_embeds"),
                                         last_only=True)
            return logits[:, -1]

    return prefill_step


def make_serve_step(model) -> Callable:
    """(params, cache, tokens, cur_pos) → (next_logits (B, V), cache); the
    cache is updated in place."""

    def serve_step(params, cache, tokens: torch.Tensor, cur_pos: int):
        with inference(params):
            if isinstance(leaves(params)[0], DTensor):
                tokens = place_inputs(model, params, {"tokens": tokens},
                                      "decode")["tokens"]
            logits, cache = model.forward_decode(params, cache, tokens,
                                                 cur_pos)
            return logits[:, -1], cache

    return serve_step


def inference(params):
    """The serving steps' grad mode: ``torch.inference_mode()``, or
    ``torch.no_grad()`` beside DTensor parameters (a DTensor view of a
    tensor made outside inference mode cannot be taken inside it)."""
    if isinstance(leaves(params)[0], DTensor):
        return torch.no_grad()
    return torch.inference_mode()


def init_state(model, gen: torch.Generator, opt: bool = True,
               mesh=None) -> Dict[str, Any]:
    """Parameters drawn from ``gen`` (on its device), with AdamW's state
    beside them unless ``opt`` is False.  With ``mesh``, the parameters
    are placed on it by ``param_specs`` (ranks that share a device drawing
    in turns), and
    the optimizer's state is made in their placements."""
    if mesh is None:
        params = model.init(gen)
    else:
        from repro_torch.launch.mesh import place_in_turns
        params = place_in_turns(lambda: model.init(gen), model.param_specs(),
                                mesh)
    if not opt:
        return {"params": params}
    return {"params": params, "opt": adamw_init(params)}


def state_specs(model, multi_pod: bool = False) -> Dict[str, Any]:
    """The sharding specs of :func:`init_state`'s tree: the optimizer's
    moments as the parameters, its step replicated."""
    ps = model.param_specs(multi_pod)
    return {"params": ps, "opt": {"mu": ps, "nu": ps, "step": P()}}
