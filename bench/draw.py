"""Everything a run draws, made from ``--seed``: sub-seeds by name, and
weights drawn in place on the device, one call per stacked tensor."""

from __future__ import annotations

import hashlib
from typing import Sequence

import torch


def sub_seed(seed: int, *parts) -> int:
    """A 63-bit seed for the draw named ``parts`` under ``seed`` (any
    whole number, however large)."""
    text = ":".join(str(p) for p in (seed, *parts)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def generator(device, seed: int, *parts) -> torch.Generator:
    """A generator on ``device`` seeded for the draw named ``parts``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, *parts))
    return gen


def normal(gen: torch.Generator, shape: Sequence[int], std: float,
           dtype: torch.dtype, mean: float = 0.0) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype,
                       device=gen.device).normal_(mean, std, generator=gen)


def uniform(gen: torch.Generator, shape: Sequence[int], lo: float,
            hi: float, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype,
                       device=gen.device).uniform_(lo, hi, generator=gen)


def tokens(gen: torch.Generator, shape: Sequence[int],
           vocab: int) -> torch.Tensor:
    """Token ids below ``vocab``, int64, on the generator's device."""
    return torch.randint(0, vocab, tuple(shape), generator=gen,
                         device=gen.device)
