"""Pipeline parallelism: the GPipe microbatch schedule as pure functions,
and the pipelined step over ``torch.distributed`` ranks.

The model's layer stack is split into ``n_stages`` contiguous groups, one
a rank of the stage axis; activations flow stage to stage around a ring
of point-to-point sends; microbatches keep every stage busy (bubble
fraction (S-1)/(M+S-1)).  :func:`pipeline_schedule` and
:func:`bubble_fraction` are the schedule as data, which the overlay
serving path (:mod:`repro_torch.serve.stagepar`) issues its launches by.

:func:`make_pipeline_train_step` runs the wavefront forward; under
autograd it keeps each step's graph and its backward runs the reverse
wavefront on every rank, giving what ``jax.grad`` of the reference's
``shard_map`` step gives: each rank's block of the stage parameters and
x's gradient on every rank.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.models.common import leaves, tree_map, unflatten


def pipeline_schedule(n_micro: int,
                      n_stages: int) -> List[Tuple[int, int, int]]:
    """The GPipe forward schedule as data: ``(step, stage, microbatch)``
    triples in execution order — microbatch m occupies stage s at step
    ``m + s``, for ``n_micro + n_stages - 1`` steps total.  Exposed as a
    pure function so the overlay serving path
    (:mod:`repro_torch.serve.stagepar`) can issue its per-partition
    launches in wavefront order on the modelled timeline, and so tests can
    assert the shape of the schedule without a mesh."""
    if n_micro < 1 or n_stages < 1:
        raise ValueError(f"n_micro and n_stages must be >= 1, got "
                         f"{n_micro!r}, {n_stages!r}")
    sched = []
    for t in range(n_micro + n_stages - 1):
        for s in range(n_stages):
            m = t - s
            if 0 <= m < n_micro:
                sched.append((t, s, m))
    return sched


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    """Idle fraction of the GPipe wavefront: (S-1)/(M+S-1)."""
    if n_micro < 1 or n_stages < 1:
        raise ValueError(f"n_micro and n_stages must be >= 1, got "
                         f"{n_micro!r}, {n_stages!r}")
    return (n_stages - 1) / (n_micro + n_stages - 1)


def exchange(t: torch.Tensor, to: int, frm: int, group) -> torch.Tensor:
    """``t`` sent to the group's rank ``to``; what its rank ``frm`` sent
    (every rank of ``group`` calls it together, each with its own pair).

    One ``all_to_all_single`` whose only nonzero splits are the pair's: the
    same code on gloo and NCCL.  gloo's point-to-point ``send``/``recv``
    on a CUDA tensor aborts (it writes the device pointer as host memory),
    while its all-to-all stages CUDA tensors through the host as its
    all-reduce does."""
    n = dist.get_world_size(group)
    sends, recvs = [0] * n, [0] * n
    sends[to] = recvs[frm] = t.numel()
    got = torch.empty_like(t, memory_format=torch.contiguous_format)
    dist.all_to_all_single(got.view(-1), t.contiguous().view(-1), recvs,
                           sends, group=group)
    return got


def make_pipeline_train_step(layer_fn: Callable, n_stages: int,
                             n_micro: int, mesh: DeviceMesh,
                             stage_axis: str = "data") -> Callable:
    """A pipelined step over the ranks of ``mesh``'s ``stage_axis``
    (``n_stages`` of them), the reference's GPipe wavefront.

    layer_fn(carry, layer_params) -> carry: one layer applied to a
    microbatch's activations of shape (mb, ...).

    The returned fn takes, on each rank:
      stage_params: the rank's block of the stage-stacked layer
                    parameters, a tree of leading dims (1,
                    layers_per_stage, ...) (the reference's
                    ``P(stage_axis)`` shard, as ``shard_map`` hands it)
      x:            (n_micro, mb, ...) microbatched activations, the same
                    on every rank
    and returns the (n_micro, mb, ...) output on every rank.

    At step t stage 0 feeds microbatch t (t < n_micro); every other stage
    feeds what arrived from its predecessor; each stage's output goes to
    the next stage around the ring ``i → (i+1) % n`` (with one stage, the
    identity: no exchange); the last stage records microbatch
    t - (n_stages - 1), and an all-reduce of the outputs times a mask
    hands them to every rank.

    With grad enabled and x or a parameter leaf requiring grad, the step
    keeps each step's graph, and its backward, which every rank must take,
    runs the wavefront in reverse: at step t a rank takes its output's
    cotangent from the next stage (the last stage adds the output's own
    cotangent for microbatch t - (n_stages - 1), once: every rank's loss
    sees the same replicated output), differentiates the step, and sends
    its feed's cotangent to the previous stage; stage 0's feeds from x
    give x's gradient, handed to every rank by a masked all-reduce.
    Junk and the bubble carry zero cotangents, sent all the same, so
    every rank takes part in every exchange of both wavefronts in the
    same order."""
    group = mesh[stage_axis].get_group()
    if dist.get_world_size(group) != n_stages:
        raise ValueError(f"{n_stages} stages on a {stage_axis!r} axis of "
                         f"{dist.get_world_size(group)} ranks")
    sid = mesh.get_local_rank(stage_axis)
    last = n_stages - 1
    n_steps = n_micro + n_stages - 1

    def shift(t, step):
        """``t`` to stage sid + step around the ring; what stage sid - step
        sent."""
        if n_stages == 1:
            return t
        return exchange(t, (sid + step) % n_stages, (sid - step) % n_stages,
                        group)

    def apply_stage(act, layers):
        for i in range(leaves(layers)[0].shape[0]):
            act = layer_fn(act, tree_map(lambda a: a[i], layers))
        return act

    def masked_to_all(t, owner):
        """Every rank's ``t`` becomes stage ``owner``'s."""
        mask = torch.full((), float(sid == owner), dtype=t.dtype,
                          device=t.device)
        t.mul_(mask)
        dist.all_reduce(t, group=group)
        return t

    def wavefront(stage_params, x, keep):
        """The forward; with ``keep`` (grad enabled) also each step's
        (feed, out) graph."""
        layers = tree_map(lambda a: a[0], stage_params)
        outputs = torch.zeros_like(x)
        inflight = torch.zeros_like(x[0])
        steps = []
        for t in range(n_steps):
            feed = x[t] if sid == 0 and t < n_micro else inflight
            if keep:
                feed = feed.detach().requires_grad_()
            out = apply_stage(feed, layers)
            if keep:
                steps.append((feed, out))
                out = out.detach()
            inflight = shift(out, 1)
            done = t - last
            if sid == last and 0 <= done < n_micro:
                outputs[done] = out
        return masked_to_all(outputs, last), steps

    def reverse(steps, params, g_out, x_like):
        """The backward wavefront → (x's gradient on every rank, the
        gradients of ``params``)."""
        grads = [None] * len(params)
        gx = torch.zeros_like(x_like)
        cot = torch.zeros_like(x_like[0])   # nothing follows the last step
        for t in reversed(range(n_steps)):
            feed, out = steps[t]
            done = t - last
            if sid == last and 0 <= done < n_micro:
                cot = cot + g_out[done]
            got = torch.autograd.grad(out, [feed, *params], cot,
                                      allow_unused=True)
            for i, g in enumerate(got[1:]):
                if g is not None:
                    grads[i] = g if grads[i] is None else grads[i] + g
            send = got[0]
            if sid == 0 and t < n_micro:    # fed from x, not the ring
                gx[t] = send
                send = torch.zeros_like(send)
            steps[t] = None
            if t > 0:
                cot = shift(send, -1)
        return masked_to_all(gx, 0), grads

    class Wavefront(torch.autograd.Function):
        @staticmethod
        def forward(ctx, like, x, *flat):
            flat = [a.detach().requires_grad_(a.requires_grad)
                    for a in flat]
            with torch.enable_grad():
                out, ctx.steps = wavefront(unflatten(like, flat), x,
                                           keep=True)
            ctx.params = [a for a in flat if a.requires_grad]
            ctx.x_like = x.new_zeros(()).expand(x.shape)
            return out

        @staticmethod
        def backward(ctx, g_out):
            gx, grads = reverse(ctx.steps, ctx.params, g_out, ctx.x_like)
            ctx.steps = ctx.params = None
            it = iter(grads)
            flat = [next(it) if n else None for n in ctx.needs_input_grad[2:]]
            return (None, gx if ctx.needs_input_grad[1] else None, *flat)

    def run(stage_params: Any, x: torch.Tensor) -> torch.Tensor:
        flat = leaves(stage_params)
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in [x, *flat]):
            return Wavefront.apply(stage_params, x, *flat)
        return wavefront(stage_params, x, keep=False)[0]

    return run
