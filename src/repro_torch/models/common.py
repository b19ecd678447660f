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
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
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


def state_from_numpy(tree: Dict[str, Any], cfg: ArchConfig,
                     device=None) -> Dict[str, Any]:
    """The JAX package's train state ``{"params", "opt": {"mu", "nu",
    "step"}}``, after ``jax.tree.map(np.asarray, state)``, as the port's:
    the parameters through :func:`params_from_numpy`, the optimizer's
    float32 moments and int32 step as they are, bit for bit, so both
    packages can start from one mid-schedule state."""
    opt = tree["opt"]

    def moments(node, path):
        if isinstance(node, dict):
            return {k: moments(v, f"{path}/{k}") for k, v in node.items()}
        t = array_to_tensor(np.asarray(node), device)
        if t.dtype != torch.float32:
            raise ValueError(f"{path}: {t.dtype}, moments are float32")
        return t
    step = array_to_tensor(np.asarray(opt["step"]), device)
    if step.dtype != torch.int32 or step.dim() != 0:
        raise ValueError(f"opt/step: {step.dtype} {tuple(step.shape)}, "
                         f"must be an int32 scalar")
    return {"params": params_from_numpy(tree["params"], cfg, device),
            "opt": {"mu": moments(opt["mu"], "opt/mu"),
                    "nu": moments(opt["nu"], "opt/nu"), "step": step}}
