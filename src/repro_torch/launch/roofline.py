"""Roofline terms of one step from the dry run's counts.

compute term    = FLOPs(per-device) / peak_FLOP/s
memory term     = bytes(per-device) / HBM_bw
collective term = Σ_ops factor·local_payload_bytes / link_bw

The JAX package reads its counts from the compiled per-device HLO.  Torch
has none: :mod:`repro_torch.launch.dryrun` counts the per-rank program as
it runs under ``FakeTensorMode`` (FLOPs, the bytes each op reads and
writes, and each collective with its local payload, :class:`Counts`), and
:func:`analyze` turns those counts into a :class:`Roofline` in the H100's
data-sheet rates (:mod:`repro_torch.launch.mesh`), never a TPU's.

A collective's payload is its result on this rank, as the HLO prints it:
the gathered tensor of an all-gather, the scattered one of a
reduce-scatter.  Ring-algorithm cost factors: all-reduce 2·(n-1)/n ≈ 2,
all-gather/reduce-scatter/all-to-all (n-1)/n ≈ 1, collective-permute 1.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterable, List, Sequence, Tuple

import torch

from repro_torch.launch.mesh import HBM_BW, ICI_BW, PEAK_FLOPS_BF16

_COLL_FACTOR = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
    "all-reduce-start": 2.0,
    "all-gather-start": 1.0,
    "collective-permute-start": 1.0,
}

# one collective as the dry run records it: (kind, dtype, local shape)
Collective = Tuple[str, torch.dtype, Sequence[int]]


def collective_bytes(records: Iterable[Collective]) -> Dict[str, float]:
    """Per-device collective payload bytes (factor-weighted) by op kind."""
    out: Dict[str, float] = {}
    for kind, dtype, shape in records:
        b = math.prod(shape) * dtype.itemsize * _COLL_FACTOR.get(kind, 1.0)
        out[kind] = out.get(kind, 0.0) + b
    return out


@dataclasses.dataclass
class Counts:
    """What the dry run counted on one rank over one step: FLOPs, the
    bytes its ops read and wrote, and its collectives."""
    flops: float
    bytes_accessed: float
    collectives: List[Collective]


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_breakdown: Dict[str, float]
    model_flops_global: float
    n_devices: int

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS_BF16

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes_per_device / ICI_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Roofline step time: max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs — how much executed compute is
        useful."""
        hlo_global = self.flops_per_device * self.n_devices
        return self.model_flops_global / hlo_global if hlo_global else 0.0

    @property
    def mfu(self) -> float:
        """Roofline-model MFU: useful FLOPs / (chips · peak · step_s)."""
        denom = self.n_devices * PEAK_FLOPS_BF16 * self.step_s
        return self.model_flops_global / denom if denom else 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "coll_bytes_per_device": self.coll_bytes_per_device,
            "coll_breakdown": self.coll_breakdown,
            "model_flops_global": self.model_flops_global,
            "n_devices": self.n_devices,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "step_s": self.step_s,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu": self.mfu,
        }


def model_flops(cfg, seq: int, batch: int, kind: str) -> float:
    """MODEL_FLOPS = 6·N·D for training (fwd+bwd), 2·N·D forward-only;
    MoE uses active params."""
    n = cfg.active_param_count() if cfg.family == "moe" \
        else cfg.param_count()
    tokens = batch * seq if kind in ("train", "prefill") else batch
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * tokens


def attention_flops(cfg, seq: int, batch: int, kind: str) -> float:
    """Forward attention-score/value FLOPs (not in 6·N·D), global."""
    if cfg.family == "ssm":
        return 0.0
    layers = cfg.n_layers if cfg.family != "hybrid" else \
        (cfg.n_layers + cfg.attn_every - 1) // cfg.attn_every
    hq, hd = cfg.n_heads, cfg.hd
    if kind == "decode":
        # one query against the whole cache: QK^T + PV
        return 4.0 * batch * hq * hd * seq * layers
    keys = min(seq, cfg.window) if cfg.window else seq
    # causal ⇒ on average half the keys are live
    per_layer = 2.0 * batch * hq * hd * seq * keys * (0.5 if not cfg.window
                                                      else 1.0) * 2.0
    total = per_layer * layers
    if cfg.family == "audio":
        # encoder self-attn (non-causal, seq frames) + decoder cross-attn
        enc = 4.0 * batch * hq * hd * seq * seq * cfg.enc_layers
        total += enc
    return total


def analytic_hlo_flops(cfg, seq: int, batch: int, kind: str,
                       remat: str = "full") -> float:
    """Analytic floor for executed FLOPs (global, all devices).

    fwd = 2·N·D + attention; train = fwd·3 (+1 fwd recompute under full
    remat).  The JAX package needs it because XLA:CPU counts library dots
    as 0 FLOPs; the port keeps it as the floor of :func:`analyze` and as
    the work no step can beat (``chip_smoke.py`` phase (q))."""
    n = cfg.active_param_count() if cfg.family == "moe" \
        else cfg.param_count()
    tokens = batch * seq if kind in ("train", "prefill") else batch
    fwd = 2.0 * n * tokens + attention_flops(cfg, seq, batch, kind)
    if kind == "train":
        return fwd * (4.0 if remat == "full" else 3.0)
    return fwd


def analyze(counts: Counts, cfg, seq: int, batch: int, kind: str,
            n_devices: int, remat: str = "full") -> Roofline:
    """The roofline of one rank's counts (:class:`Counts`, from
    :func:`repro_torch.launch.dryrun.trace_cell`); the FLOPs floored at
    the analytic count's share of a device, as in the JAX package."""
    flops = max(float(counts.flops),
                analytic_hlo_flops(cfg, seq, batch, kind, remat) / n_devices)
    coll = collective_bytes(counts.collectives)
    return Roofline(
        flops_per_device=flops,
        bytes_per_device=float(counts.bytes_accessed),
        coll_bytes_per_device=sum(coll.values()),
        coll_breakdown=coll,
        model_flops_global=model_flops(cfg, seq, batch, kind),
        n_devices=n_devices,
    )
