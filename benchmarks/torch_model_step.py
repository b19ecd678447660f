#!/usr/bin/env python3
"""Reduced-model step times for every assigned architecture: the port of
``benchmarks/model_step.py``, on one CUDA card.

    PYTHONPATH=src python3 benchmarks/torch_model_step.py [--device cpu]

For each architecture at its smoke-scale config (``reduced_config``,
``remat_policy="none"``, B=2, S=32 token ids from a numpy seed; whisper's
decoder takes the first 8, after 32 zero frames; internvl2's first 4
positions are zero patch embeddings), one warm-up train step and then the
mean of three (``make_train_step``, AdamW), and the same for one decode
step (``make_serve_step`` at position 0 of a 32-slot cache).  Catches
pathological regressions in the model code itself: the gate is that every
loss and every logit is finite.  Prints the reference's
``name,us_per_call,derived`` rows through ``--json`` and the harness
(``benchmarks/torch_run.py --suite model_step``); exits 2 without a card.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402
import port_bench  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.registry import ALL_ARCHS, reduced_config  # noqa
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train.step import (init_state, make_serve_step,  # noqa
                                    make_train_step)

B, S, REPS = 2, 32, 3


def _batch(cfg, device) -> Dict[str, torch.Tensor]:
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (B, S))
    batch = {"tokens": toks, "labels": toks}
    if cfg.frontend == "vision":
        batch["input_embeds"] = np.zeros((B, S // 8, cfg.d_model),
                                         np.float32)
    if cfg.frontend == "audio":
        batch["input_embeds"] = np.zeros((B, S, cfg.d_model), np.float32)
        batch["tokens"] = batch["labels"] = toks[:, :8]
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _mean_us(fn, device: str) -> float:
    """Host µs per call over REPS calls after one warm-up, each ending in a
    synchronise on the card."""
    def sync():
        if device != "cpu":
            torch.cuda.synchronize()
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(REPS):
        fn()
    sync()
    return (time.perf_counter() - t0) / REPS * 1e6


def run(device: str = "cuda",
        archs: Optional[Sequence[str]] = None) -> Dict:
    dev = torch.device(device)
    out, failures = [], []
    for arch in archs or sorted(ALL_ARCHS):
        cfg = reduced_config(ALL_ARCHS[arch])
        model = build_model(cfg, remat_policy="none")
        state = init_state(model, torch.Generator(device=dev).manual_seed(0))
        batch = _batch(cfg, dev)
        step = make_train_step(model, AdamWConfig())
        res = {}

        def train():
            res["state"], res["m"] = step(state, batch)
        train_us = _mean_us(train, device)
        loss = float(res["m"]["loss"])
        serve = make_serve_step(model)
        cache = model.init_cache(B, S, device=dev)
        tok = batch["tokens"][:, :1]

        def decode():
            res["logits"], _ = serve(state["params"], cache, tok, 0)
        decode_us = _mean_us(decode, device)
        finite = bool(torch.isfinite(res["logits"]).all())
        if not (np.isfinite(loss) and finite):
            failures.append(f"{arch}: loss {loss}, finite logits {finite}")
        out.append(dict(arch=arch, train_us=train_us, decode_us=decode_us,
                        loss=loss))
        del state, cache
    return dict(device=port_bench.card_line(device), rows=out,
                gate_failures=failures)


def rows(result: Dict) -> List[Dict]:
    """The reference's rows (one train step an architecture), then the
    port's decode step."""
    return ([dict(name=f"model_step/{r['arch']}", us_per_call=r["train_us"],
                  derived=f"loss={r['loss']:.3f} reduced b={B} s={S}")
             for r in result["rows"]]
            + [dict(name=f"model_step/{r['arch']}/decode",
                    us_per_call=r["decode_us"],
                    derived=f"reduced b={B} cache={S}")
               for r in result["rows"]])


def report(result: Dict) -> None:
    for row in rows(result):
        print(f"{row['name']},{row['us_per_call']:.2f},\"{row['derived']}\"")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    return port_bench.bench_main("torch_model_step", ap, argv, run, report)


if __name__ == "__main__":
    sys.exit(main())
