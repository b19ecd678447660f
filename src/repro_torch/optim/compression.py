"""Gradient compression for the data-parallel all-reduce:
``repro/optim/compression.py`` restated.

int8 symmetric quantisation, no stochastic rounding, with error feedback
(EF-SGD style): the quantisation residual is carried to the next step, so
the compressed reduction stays unbiased over time.  Used by
:mod:`repro_torch.train.dp_compressed` over the data axis's process group.

What goes over the wire is what the reference's ``psum`` sums: each
member's dequantised float32 ``q·s``, not the int8 ``q``, so the payload
is as large as an uncompressed float32 all-reduce (``PERF.md`` section 7).

Rounding is half to even (``torch.round``, as ``jnp.round``), and every
division is by a tensor: on a CUDA tensor, dividing by a Python number
multiplies by its reciprocal, which can differ from the quotient in the
last bit.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.models.common import leaves, tree_map, unflatten


def _amax(xf: torch.Tensor) -> torch.Tensor:
    """max |xf| without a temporary of xf's size (|min| is exact)."""
    lo, hi = torch.aminmax(xf)
    return torch.maximum(-lo, hi)


def _scale(xf: torch.Tensor) -> torch.Tensor:
    """max|xf| / 127 + 1e-12 in float32, a tensor on xf's device."""
    return _amax(xf) / torch.full((), 127.0, device=xf.device) + 1e-12


def _rounded(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """clip(round(xf / scale), -127, 127) in float32: q's values."""
    return torch.div(xf, scale).round_().clamp_(-127, 127)


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (q int8 in [-127, 127], scale as a float32 0-d tensor)."""
    xf = x.float()
    scale = _scale(xf)
    return _rounded(xf, scale).to(torch.int8), scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_pytree(grads, error):
    """→ (quantised tree, scales tree, new error feedback)."""
    qs, ss, es = [], [], []
    for g, e in zip(leaves(grads), leaves(error)):
        gf = g.float() + e
        q, s = _quantize(gf)
        qs.append(q)
        ss.append(s)
        es.append(gf - _dequantize(q, s))
    return (unflatten(grads, qs), unflatten(grads, ss),
            unflatten(grads, es))


def decompress_pytree(qs, scales):
    return tree_map(_dequantize, qs, scales)


def error_feedback_allreduce(grads, error, group=None
                             ) -> Tuple[Any, Any]:
    """Compressed all-reduce over ``group`` (default: the world): each
    member quantises its local gradients with its error feedback, the
    dequantised ``q·s`` is summed over the group and divided by its size.

    → (reduced float32 gradients, the error feedback).  ``error``'s leaves
    (float32) are updated IN PLACE and returned as the new state.  Leaf
    by leaf, the float32 temporaries are one leaf's: ``e += g``, the
    rounded values in one tensor, ``e -= deq``, then that tensor is
    all-reduced in place (over a group of one rank too) and becomes the
    leaf's reduced gradient.  Each gradient leaf is dropped from ``grads``
    (a dict tree, emptied here) as its leaf is reduced, so its memory goes
    as the reduced ones come.
    """
    n = dist.get_world_size(group)
    size = None
    out = []
    for e, g in zip(leaves(error), _pop_leaves(grads)):
        if size is None:
            size = torch.full((), float(n), device=e.device)
        e.add_(g)
        del g
        scale = _scale(e)
        deq = _rounded(e, scale).mul_(scale)
        e.sub_(deq)
        dist.all_reduce(deq, group=group)
        out.append(deq.div_(size))
    return unflatten(error, out), error


def _pop_leaves(tree):
    """Every leaf of a dict tree in :func:`leaves` order, each removed from
    its dict as it is handed out."""
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _pop_leaves(tree[key])
        else:
            yield tree.pop(key)
