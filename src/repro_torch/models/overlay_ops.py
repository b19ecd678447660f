"""Model pointwise datapaths routed through the paper's overlay JIT.

Where the pointwise math is overlay-expressible (DSP ops: ±, ×, min/max,
fused mul-add), it is JIT-compiled through the full pipeline once, at first
use, and its DFG runs in compiled mode (``CompiledKernel.__call__``: the
routed graph evaluated as torch ops on the tensors' own device and dtype —
semantically the configured overlay).  Transcendentals (exp in silu) are
not DSP-block ops, so gated-silu splits: the sigmoid stays ``torch.sigmoid``
in float32, the gating product runs on the overlay DFG.

The JIT'd kernels are cached process-wide; their CompiledKernel objects are
inspectable.
"""

from __future__ import annotations

import threading
from typing import Dict

import torch

from repro_torch.core.jit import CompiledKernel, jit_compile
from repro_torch.core.options import CompileOptions
from repro_torch.core.overlay import OverlaySpec

_SPEC = OverlaySpec(width=8, height=8, dsp_per_fu=2)
_CACHE: Dict[str, CompiledKernel] = {}
_LOCK = threading.Lock()

# every overlay-expressible datapath this module JITs, by name:
# name -> (traceable python callable, arity)
KERNELS: Dict[str, tuple] = {
    "squared_relu": (lambda a: a.max(0.0) * a.max(0.0), 1),
    "gate_mul2": (lambda a, b, c: a * b * c, 3),
    "residual_add": (lambda a, b: a + b, 2),
}


def _get(name: str) -> CompiledKernel:
    with _LOCK:
        if name not in _CACHE:
            fn, n_inputs = KERNELS[name]
            _CACHE[name] = jit_compile(
                fn, _SPEC, opts=CompileOptions(n_inputs=n_inputs, name=name,
                                               max_replicas=1,
                                               place_effort=0.25))
        return _CACHE[name]


def squared_relu(x: torch.Tensor) -> torch.Tensor:
    """max(x,0)^2 — nemotron-4's activation; fully overlay-expressible."""
    return _get("squared_relu")(x)


def gated_silu(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """silu(g) * u.  sigmoid is transcendental (torch, float32); the two
    products are the overlay datapath."""
    s = torch.sigmoid(g.float()).to(g.dtype)
    return _get("gate_mul2")(g, s, u)


def ssm_gate(y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """y * silu(z) for the Mamba2 output gate."""
    s = torch.sigmoid(z.float()).to(z.dtype)
    return _get("gate_mul2")(y, z, s)


def residual_add(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    return _get("residual_add")(x, r)


def compiled_kernels() -> Dict[str, CompiledKernel]:
    """Expose the JIT'd overlay kernels for inspection/benchmarks."""
    return dict(_CACHE)
