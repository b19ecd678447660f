"""The numbers that decide ``correct``: the program's outputs against the
reference's, and the sample of steps they are read on."""

from __future__ import annotations

import random
import statistics
from typing import Dict, List

import torch

from bench import draw


def sample_steps(candidates: List[int], k: int, seed: int) -> List[int]:
    """The last of ``candidates`` and ``k - 1`` others drawn from ``seed``."""
    if not candidates:
        return []
    rest = random.Random(draw.sub_seed(seed, "check")).sample(
        candidates[:-1], min(k - 1, len(candidates) - 1))
    return sorted(rest) + [candidates[-1]]


def rows(prog: torch.Tensor, ref: torch.Tensor) -> Dict[str, List[float]]:
    """Rows of logits (B, V) against the reference's (float32), row by row:
    ``rel``, ||prog - ref|| / ||ref||; ``max``, the largest |prog - ref|
    over the reference's standard deviation in the row; ``gap``, the gap
    by which the reference's logit of the program's top token lies below
    the reference's best, in the row's standard deviations."""
    p, r = prog.float().to(ref.device), ref
    d = p - r
    std = r.std(-1)
    pick = p.argmax(-1, keepdim=True)
    return {"rel": (d.norm(dim=-1) / r.norm(dim=-1)).tolist(),
            "max": (d.abs().amax(-1) / std).tolist(),
            "gap": ((r.amax(-1) - r.gather(-1, pick)[:, 0]) / std).tolist()}


def logits(rows_: Dict[str, List[float]]) -> Dict[str, float]:
    """The compared numbers over every row read (:func:`rows`, joined):
    ``logit_rel_err``, the worst row's; ``logit_rel_err_median``, the
    median row's; ``logit_max_err`` and ``top1_gap``, the worst row's."""
    return {"logit_rel_err": max(rows_["rel"]),
            "logit_rel_err_median": statistics.median(rows_["rel"]),
            "logit_max_err": max(rows_["max"]),
            "top1_gap": max(rows_["gap"])}


def join(into: Dict[str, List[float]], new: Dict[str, List[float]]) -> None:
    """Append ``new``'s rows to ``into``'s."""
    for k, v in new.items():
        into.setdefault(k, []).extend(v)


def rel(a: torch.Tensor, ref: torch.Tensor) -> float:
    """||a - ref|| / ||ref||, in float32."""
    r = ref.float()
    return ((a.float().to(r.device) - r).norm() / r.norm()).item()
