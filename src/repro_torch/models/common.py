"""Shared architecture config, parameter init and the weight carry-over.

Every assigned architecture is an ``ArchConfig``; families:
  dense   — decoder-only GQA transformer (yi, qwen3, llama3, nemotron,
            internvl backbone)
  moe     — mixture-of-experts transformer (mixtral, qwen3-moe)
  ssm     — Mamba2 / SSD (attention-free)
  hybrid  — Mamba2 backbone + shared attention blocks (zamba2)
  audio   — whisper encoder-decoder (conv frontend stubbed)
  vlm     — internvl (ViT frontend stubbed; backbone = dense)

The port builds all six families.  Parameters are nested dictionaries
of tensors in the JAX package's layout: per-layer tensors stacked along a
leading layer axis, weights ``(in, out)`` as in ``x @ W``, so
:func:`params_from_numpy` carries the JAX package's parameters across as a
plain copy.  Every floating leaf is in the config's dtype except those
named in :data:`FLOAT32_LEAVES`, which stay float32 whatever it is.

The DTensor seams (the last section) are what the model's layers use
where a tensor, expert or data parallel mesh meets a kernel or a
computation written for one rank.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.placement_types import Placement
from torch.utils import checkpoint as ckpt


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # 0 → d_model // n_heads
    qk_norm: bool = False
    activation: str = "swiglu"        # swiglu | squared_relu
    rope_theta: float = 1e4
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # SSM
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4
    # hybrid
    attn_every: int = 0               # shared attn block period (zamba2)
    # attention variants
    window: Optional[int] = None      # sliding-window attention (mixtral)
    # enc-dec (whisper)
    enc_layers: int = 0
    # frontends (stubs)
    frontend: Optional[str] = None    # 'audio' | 'vision' | None
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to 256 so the embedding shards on any mesh axis
        (logits over padding ids are trained down by the CE loss; labels
        never reference them)."""
        return (self.vocab + 255) // 256 * 256

    @property
    def is_subquadratic(self) -> bool:
        """Can this arch run long_500k (sub-quadratic token mixing)?"""
        return self.family in ("ssm", "hybrid") or self.window is not None

    def param_count(self) -> int:
        """Total parameters N (for 6·N·D roofline bookkeeping)."""
        d, ff, v, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd, hq, hkv = self.hd, self.n_heads, self.n_kv_heads
        attn = d * hd * (hq + 2 * hkv) + hq * hd * d
        if self.activation == "swiglu":
            mlp = 3 * d * ff
        else:
            mlp = 2 * d * ff
        if self.family in ("moe",):
            mlp = self.n_experts * 3 * d * self.moe_d_ff + d * self.n_experts
        per_layer = attn + mlp + 2 * d
        if self.family == "ssm":
            di = self.ssm_expand * d
            per_layer = (d * (2 * di + 2 * self.ssm_state +
                              di // self.ssm_head_dim)
                         + di * self.conv_width + di * d + 2 * d)
        if self.family == "hybrid":
            di = self.ssm_expand * d
            ssm_l = (d * (2 * di + 2 * self.ssm_state +
                          di // self.ssm_head_dim)
                     + di * self.conv_width + di * d + 2 * d)
            per_layer = ssm_l   # plus one shared attn block added below
        total = L * per_layer + v * d * 2   # tied-off embed + lm head
        if self.family == "hybrid":
            total += attn + 3 * d * ff + 2 * d
        if self.family == "audio":
            total += self.enc_layers * (attn + mlp + 2 * d)
            total += L * (attn + d * hd * (hq + 2 * hkv) // 1)  # cross-attn
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.family != "moe":
            return self.param_count()
        d, L = self.d_model, self.n_layers
        hd, hq, hkv = self.hd, self.n_heads, self.n_kv_heads
        attn = d * hd * (hq + 2 * hkv) + hq * hd * d
        mlp = self.top_k * 3 * d * self.moe_d_ff + d * self.n_experts
        return int(L * (attn + mlp + 2 * d) + self.vocab * d * 2)


# ---------------------------------------------------------- parameter trees
# Nested dictionaries of tensors (parameters, optimizer and train state),
# flattened as ``jax.tree.flatten`` flattens a pytree of dicts: keys in
# sorted order, depth first.  The order is what the optimizer's global-norm
# sum and the checkpoint's array indices follow, so both packages number a
# state's arrays alike.

def leaves(tree: Any) -> List[Any]:
    """Every leaf of ``tree``, dict keys in sorted order."""
    return list(_walk(tree))


def _walk(node: Any) -> Iterator[Any]:
    if isinstance(node, dict):
        for key in sorted(node):
            yield from _walk(node[key])
    else:
        yield node


def unflatten(like: Any, values: Sequence[Any]) -> Any:
    """A tree of ``like``'s structure holding ``values`` in
    :func:`leaves` order."""
    it = iter(values)

    def build(node):
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more values than leaves")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf over trees of one structure."""
    if isinstance(tree, dict):
        if any(not isinstance(r, dict) or sorted(r) != sorted(tree)
               for r in rest):
            raise ValueError("trees of different structure")
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest))
                for key in sorted(tree)}
    return fn(tree, *rest)


# the top-level parameter subtrees whose leaves stack the layers along a
# leading axis (the rest, ``lm`` and zamba2's ``shared``, are unstacked)
STACKED = frozenset({"layers", "enc", "dec"})


# ------------------------------------------------------------------- remat

# the JAX package's remat policies: ``jax.checkpoint`` around each layer
# body ("full"), with ``checkpoint_dots`` ("dots"), or not at all ("none")
REMAT_POLICIES = ("none", "full", "dots")

# the matrix products whose outputs "dots" keeps (what jnp.matmul and
# einsum reach at the dispatcher), as ``checkpoint_dots`` keeps
# dot_general's
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default,
                   torch.ops.aten.baddbmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def checked_remat_policy(policy: str) -> str:
    """``policy``, or a ValueError naming the policies there are."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat policy {policy!r} not in {REMAT_POLICIES}")
    return policy


def remat(body: Callable, policy: str) -> Callable:
    """``body`` as one layer of a training forward under ``policy``:
    "full" keeps only its inputs and recomputes it in the backward
    (``torch.utils.checkpoint`` without reentry), "dots" keeps the matrix
    products' outputs as well (a selective-checkpoint policy), "none"
    keeps everything.  The recompute launches the forward kernels again.
    With grad mode off (serving) the body runs as it is."""
    if checked_remat_policy(policy) == "none":
        return body
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)

    def run(*args):
        if not torch.is_grad_enabled():
            return body(*args)
        return ckpt.checkpoint(body, *args, **kw)
    return run


# ----------------------------------------------------------- sharding rules
# The reference's sharding rules as data.  A spec is a tuple with one entry
# per tensor dimension: the mesh axis that dimension is split over, a tuple
# of axes, or None (replicated); :func:`repro_torch.launch.mesh.place`
# places a tree of tensors on a mesh by a tree of specs.

class P(tuple):
    """``jax.sharding.PartitionSpec`` as a tuple: ``P("data", None)``.  An
    entry of one axis in a tuple is that axis, as the reference
    normalises it."""

    def __new__(cls, *axes):
        return super().__new__(cls, (
            a[0] if isinstance(a, tuple) and len(a) == 1 else a
            for a in axes))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def logical_to_mesh_axes(multi_pod: bool) -> Dict[str, Any]:
    batch = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": batch, "vocab": "model", "heads": "model", "kv_heads": None,
        "ff": "model", "embed": None, "experts": "model", "seq": None,
        "kv_seq": "data", "layers": None, "ssm_inner": "model",
    }


def spec(*logical: Optional[str], multi_pod: bool = False) -> P:
    rules = logical_to_mesh_axes(multi_pod)
    return P(*(None if name is None else rules[name] for name in logical))


def stack_spec(tree: Any) -> Any:
    """Each spec of ``tree`` with the stacked layer axis prepended
    (replicated), as the reference prepends its scan axis."""
    return tree_map(lambda s: P(None, *s), tree)


# ------------------------------------------------------------ DTensor seams
# Tensor, expert and data parallelism through DTensor: what the model's
# seams need where a hand-written kernel or a computation written for one
# rank meets ``torch.distributed.tensor.DTensor``.
#
# On a mesh with an axis above 1 every parameter, optimizer leaf, cache and
# batch is a DTensor placed by its spec
# (:func:`repro_torch.launch.mesh.place`).
# The matrix products run as DTensor ops (column-parallel products leave
# their output sharded, row-parallel ones leave a ``Partial`` sum that
# :func:`reduce` all-reduces, as Megatron lays them out); everything else,
# the kernels included, runs in a *local region*: the DTensors' local shards
# go in through ``to_local`` and the result comes back through
# :func:`from_local` with the placements the region declares.
#
# A local region must say where the gradients of its inputs are partial
# sums.  ``to_local`` labels a gradient with the input's own placements by
# default, which is wrong for a replicated weight applied to sharded
# activations: each rank holds only its rows' (or heads') share of the
# weight's gradient.  :func:`weight_grad` gives the placements for such a
# weight (``Partial`` wherever the activation is sharded), and the
# train step's redistribution to the parameter's placements sums them.
#
# A dimension that its mesh axes do not divide evenly (a context-parallel
# prefill's sequence) is split as ``torch.chunk`` splits it (:func:`block`):
# such a DTensor is made with its global shape (:func:`from_local`) and
# gathered padded to its blocks' ceiling.
#
# Gathers go through ``torch.distributed.all_gather_into_tensor``
# (:func:`gather`, :func:`full`), never DTensor's own all-gather: torch
# 2.11's functional all-gather, which DTensor calls, crashes the process on
# gloo with CUDA tensors (the ranks that share one card run on gloo).  The
# all-reduces and reduce-scatters stay DTensor's.



Placements = Tuple[Placement, ...]


def local(t):
    """``t``'s local shard where it is a DTensor, else ``t``."""
    return t.to_local() if isinstance(t, DTensor) else t


def full(t):
    """``t`` whole on every rank where it is a DTensor (a collective:
    partial sums all-reduced, shards gathered), else ``t``."""
    if not isinstance(t, DTensor):
        return t
    t = reduce(t)
    for d in sorted({p.dim % t.ndim for p in t.placements
                     if isinstance(p, Shard)}):
        t = gather(t, d)
    return t.to_local()


def replicated(mesh: DeviceMesh) -> Placements:
    return (Replicate(),) * mesh.ndim


def from_local(t: torch.Tensor, mesh: DeviceMesh,
               placements: Sequence[Placement],
               shape: Optional[Sequence[int]] = None) -> DTensor:
    """``t`` as the local shard of a DTensor of shards of equal size, or,
    where the global ``shape`` given is not what those would make, of
    shards split as ``torch.chunk`` splits (the last ones shorter): such a
    DTensor takes a contiguous tensor's strides, as the activations split
    so are."""
    out = DTensor.from_local(t, mesh, tuple(placements), run_check=False)
    if shape is None or out.shape == torch.Size(shape):
        return out
    shape = torch.Size(shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(t, mesh, tuple(placements), run_check=False,
                              shape=shape, stride=stride)


def mesh_dims(t, dim: int) -> Tuple[int, ...]:
    """The mesh dimensions that shard tensor dimension ``dim`` of ``t``
    (none for a plain tensor)."""
    if not isinstance(t, DTensor):
        return ()
    dim %= t.ndim
    return tuple(i for i, p in enumerate(t.placements)
                 if isinstance(p, Shard) and p.dim % t.ndim == dim)


def _split(size: int, mesh: DeviceMesh, dims: Sequence[int]):
    """``size`` positions split over the mesh dimensions ``dims``, taken
    left to right, each as ``torch.chunk`` (and DTensor's ``Shard``)
    splits: blocks of the ceiling, the last ones shorter or empty where
    the split is uneven → (this rank's start, its length, and for each of
    ``dims`` the length it splits on this rank and its blocks' ceiling)."""
    start, levels = 0, []
    for i in dims:
        step, r = -(-size // mesh.size(i)), mesh.get_local_rank(i)
        levels.append((size, step))
        start += r * step
        size = max(0, min(step, size - r * step))
    return start, size, levels


def block(size: int, mesh: DeviceMesh, dims: Sequence[int]
          ) -> Tuple[int, int]:
    """(start, length) of this rank's block of ``size`` positions split
    over the mesh dimensions ``dims`` (:func:`_split`)."""
    return _split(size, mesh, dims)[:2]


def offset(t, dim: int) -> int:
    """Where this rank's shard of ``t`` starts along ``dim`` (the mesh
    dimensions that shard it taken left to right, as DTensor does; 0 for
    a plain tensor)."""
    if not isinstance(t, DTensor):
        return 0
    return block(t.shape[dim], t.device_mesh, mesh_dims(t, dim))[0]


def with_placement(pl: Sequence[Placement], dims: Sequence[int],
                   p: Placement) -> Placements:
    """``pl`` with the placement of mesh dimensions ``dims`` set to ``p``."""
    return tuple(p if i in dims else q for i, q in enumerate(pl))


def weight_grad(w: DTensor, act: DTensor) -> Placements:
    """The placements of the local gradient of weight ``w`` in a local
    region whose activation is ``act``: ``w``'s own shards where it is
    sharded; else a partial sum where ``act`` is sharded (each rank saw
    only its rows or heads); else replicated."""
    return tuple(
        p if isinstance(p, Shard)
        else Partial() if isinstance(a, Shard) else Replicate()
        for p, a in zip(w.placements, act.placements))


def local_weight(w, act):
    """Weight ``w``'s local shard for a local region whose activation is
    ``act``, its gradient labelled by :func:`weight_grad`; a plain ``w``
    as it is."""
    if not isinstance(w, DTensor):
        return w
    return w.to_local(grad_placements=weight_grad(w, act))


def reduce(t):
    """``t`` with every ``Partial`` placement summed (an all-reduce over
    those mesh dimensions); a plain tensor as it is.  The backward is a
    no-op: the replicated gradient is each partial term's."""
    if not isinstance(t, DTensor) or not any(
            isinstance(p, Partial) for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, tuple(
        Replicate() if isinstance(p, Partial) else p for p in t.placements))


def all_reduce(t: torch.Tensor, mesh: DeviceMesh, dims: Sequence[int],
               op: str = "sum") -> torch.Tensor:
    """A local tensor reduced by ``op`` ("sum" or "max") over the mesh
    dimensions ``dims`` → the local result (the same on those ranks).
    For "sum" the backward passes the gradient through to every term."""
    if not dims:
        return t
    pl = tuple(Partial(op) if i in dims else Replicate()
               for i in range(mesh.ndim))
    return from_local(t, mesh, pl).redistribute(
        mesh, replicated(mesh)).to_local()


def gather(t: DTensor, dim: int) -> DTensor:
    """``t`` whole along ``dim`` on every rank (an all-gather over the mesh
    dimensions that shard it; an uneven split is padded to its blocks'
    ceiling for the exchange and trimmed); in the backward the gradient's
    partial terms are summed (an all-reduce) and each rank keeps its
    shard."""
    mesh, dim = t.device_mesh, dim % t.ndim
    dims = mesh_dims(t, dim)
    whole = gather_local(t.to_local(), mesh, dims, dim, t.shape[dim])
    return from_local(whole, mesh,
                      with_placement(t.placements, dims, Replicate()),
                      shape=t.shape)


def gather_local(x: torch.Tensor, mesh: DeviceMesh, dims: Sequence[int],
                 dim: int, size: int) -> torch.Tensor:
    """This rank's block ``x`` of a tensor of ``size`` positions along
    ``dim``, split over the mesh dimensions ``dims`` as :func:`block`
    says → the whole tensor, on every rank (differentiable as
    :func:`gather`)."""
    return _Gather.apply(x, mesh, tuple(dims), dim % x.ndim, size)


class _Gather(torch.autograd.Function):
    """A local shard → the whole tensor of ``size`` positions along
    ``dim`` over mesh dimensions ``dims`` (the innermost gathered first,
    each level's blocks padded to their ceiling and the result trimmed);
    the backward is given the whole, summed gradient and returns this
    rank's shard of it."""

    @staticmethod
    def forward(ctx, x, mesh: DeviceMesh, dims, dim: int, size: int):
        ctx.mesh, ctx.dims, ctx.dim, ctx.size = mesh, dims, dim, size
        y = x.movedim(dim, 0).contiguous()
        for i, (length, step) in reversed(list(zip(
                dims, _split(size, mesh, dims)[2]))):
            if y.shape[0] < step:
                y = torch.cat([y, y.new_zeros((step - y.shape[0],
                                               *y.shape[1:]))])
            out = y.new_empty((mesh.size(i) * step, *y.shape[1:]))
            dist.all_gather_into_tensor(out, y, group=mesh.get_group(i))
            y = out[:length]
        # in ``x``'s own layout: the kernels take rows of unit stride
        return y.movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        start, n = block(ctx.size, ctx.mesh, ctx.dims)
        return (g.narrow(ctx.dim, start, n).contiguous(), None, None, None,
                None)


def whole(w, act):
    """Weight ``w`` gathered whole on every rank over the mesh dimensions
    that shard it (through :func:`gather`), as a local tensor whose
    gradient is a partial sum wherever ``act`` is sharded (as
    :func:`local_weight` labels it); a plain ``w`` as it is."""
    if not isinstance(w, DTensor):
        return w
    for d in sorted({p.dim % w.ndim for p in w.placements
                     if isinstance(p, Shard)}):
        w = gather(w, d)
    return local_weight(w, act)


def same_placements(fn: Callable, *ts):
    """``fn`` of DTensors that share one set of placements, run on their
    local shards → a DTensor of those placements.  For elementwise and
    other functions that act on each shard alone (the gradients are the
    shards' own); plain tensors go through ``fn`` as they are."""
    dts = [t for t in ts if isinstance(t, DTensor)]
    if not dts:
        return fn(*ts)
    pl = dts[0].placements
    if any(t.placements != pl for t in dts):
        raise ValueError(f"placements differ: {[t.placements for t in dts]}")
    out = fn(*(local(t) for t in ts))
    return from_local(out, dts[0].device_mesh, pl)


def as_dtensor(t, mesh: DeviceMesh):
    """A plain tensor that every rank holds whole as a replicated DTensor;
    a DTensor as it is."""
    if isinstance(t, DTensor):
        return t
    return from_local(t, mesh, replicated(mesh))


# --------------------------------------------------------------- init utils

def dense_init(gen: torch.Generator, shape: Sequence[int],
               dtype: torch.dtype = torch.bfloat16, device=None,
               n_stack: int = 0, scale_axis: int = 0) -> torch.Tensor:
    """Normal(0, 1) · shape[scale_axis]^-0.5, drawn in float32 from
    ``gen`` (which must live on ``device``) and cast to ``dtype``.

    ``n_stack`` > 0 stacks that many independent draws along a new leading
    layer axis, drawn one layer at a time and scaled in place, so the
    float32 draw never holds more than one layer once (at qwen3-moe's
    experts, 3.2 GB a layer, a second float32 copy set a card's peak)."""
    scale = shape[scale_axis] ** -0.5

    def draw():
        return torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                           device=device).mul_(scale)
    if not n_stack:
        return draw().to(dtype)
    out = torch.empty((n_stack, *shape), dtype=dtype, device=device)
    for i in range(n_stack):
        out[i].copy_(draw())
    return out


# ------------------------------------------------------- weight carry-over

# leaves the JAX package keeps in float32 whatever the model's dtype: the
# MoE router (repro/models/moe.py) and Mamba2's decay, skip and step bias
# (repro/models/mamba2.py)
FLOAT32_LEAVES = frozenset({"router", "A_log", "D", "dt_bias"})


def array_to_tensor(a: np.ndarray, device=None) -> torch.Tensor:
    """A numpy array as a tensor on ``device``, bit for bit.  A JAX
    bfloat16 array arrives with ml_dtypes' ``bfloat16`` dtype, which torch
    cannot read: it goes through its 16-bit integer view.  The array is
    copied, so the tensor never shares a read-only JAX buffer."""
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_numpy(tree: Dict[str, Any], cfg: ArchConfig,
                      device=None) -> Dict[str, Any]:
    """The JAX package's parameter pytree, after
    ``jax.tree.map(np.asarray, params)``, as the port's parameters: the
    same nested dictionaries with every leaf a tensor on ``device``.

    A plain copy: layouts agree (see the module docstring).  Every floating
    leaf must already be ``cfg.dtype``, or float32 where its name is in
    :data:`FLOAT32_LEAVES`; a mismatch raises rather than rounding
    silently."""
    def conv(node, path, name):
        if isinstance(node, dict):
            return {k: conv(v, f"{path}/{k}", k) for k, v in node.items()}
        t = array_to_tensor(np.asarray(node), device)
        if not t.is_floating_point():
            return t
        if name in FLOAT32_LEAVES:
            if t.dtype != torch.float32:
                raise ValueError(f"{path}: {t.dtype}, must be float32 "
                                 f"whatever the config's dtype")
        elif t.dtype != cfg.dtype:
            raise ValueError(f"{path}: {t.dtype}, config says {cfg.dtype}")
        return t
    return conv(tree, "", "")


def _float32_tree(node, path: str, device, what: str):
    if isinstance(node, dict):
        return {k: _float32_tree(v, f"{path}/{k}", device, what)
                for k, v in node.items()}
    t = array_to_tensor(np.asarray(node), device)
    if t.dtype != torch.float32:
        raise ValueError(f"{path}: {t.dtype}, {what} are float32")
    return t


def state_from_numpy(tree: Dict[str, Any], cfg: ArchConfig,
                     device=None) -> Dict[str, Any]:
    """The JAX package's train state ``{"params", "opt": {"mu", "nu",
    "step"}}`` (and the compressed step's ``"ef"``), after
    ``jax.tree.map(np.asarray, state)``, as the port's: the parameters
    through :func:`params_from_numpy`, the optimizer's float32 moments,
    its int32 step and the float32 error feedback as they are, bit for
    bit, so both packages can start from one mid-schedule state."""
    opt = tree["opt"]
    step = array_to_tensor(np.asarray(opt["step"]), device)
    if step.dtype != torch.int32 or step.dim() != 0:
        raise ValueError(f"opt/step: {step.dtype} {tuple(step.shape)}, "
                         f"must be an int32 scalar")
    out = {"params": params_from_numpy(tree["params"], cfg, device),
           "opt": {"mu": _float32_tree(opt["mu"], "opt/mu", device,
                                       "moments"),
                   "nu": _float32_tree(opt["nu"], "opt/nu", device,
                                       "moments"),
                   "step": step}}
    if "ef" in tree:
        out["ef"] = _float32_tree(tree["ef"], "ef", device,
                                  "error feedback leaves")
    return out
