#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase (k) for one model family, or its phase (n)
(training qwen3-14b), at a chosen depth on one CUDA card, with every check
printed instead of stopping the run.

The reading it exists for is the card left free at the phase's peak: it
is what fixes ``chip_smoke.MOE_LAYERS``, the deepest cut of
qwen3-moe-235b-a22b that leaves ``chip_smoke.FREE_GB`` free, and
``chip_smoke.TRAIN_LAYERS``, the deepest cut of qwen3-14b that trains with
as much free.  Run it one layer deeper than the cut to see that cut hold:

    python3 benchmarks/torch_family_depth.py --family moe --layers 14
    python3 benchmarks/torch_family_depth.py --family train --layers 10

Exits 2 without a card, 1 when a check failed or the phase raised.
"""

from __future__ import annotations

import argparse
import sys
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", choices=("moe", "ssm", "train"),
                    default="moe")
    ap.add_argument("--layers", type=int, default=None,
                    help="moe: layers kept of qwen3-moe-235b-a22b's 94 "
                         "(default: chip_smoke.MOE_LAYERS); train: of "
                         "qwen3-14b's 40 (default: chip_smoke.TRAIN_LAYERS)")
    ap.add_argument("--no-checkpoint", action="store_true",
                    help="train: skip the checkpoint and the restart (the "
                         "state at a deep cut outgrows the disk a run may "
                         "write)")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        print("torch_family_depth: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    failed = []

    def report(cond: bool, msg: str) -> None:
        if not cond:
            failed.append(msg)
            cs.log(f"CHECK FAILED: {msg}")
    cs.check = report
    if args.layers is not None:
        cs.MOE_LAYERS = cs.TRAIN_LAYERS = args.layers
    if args.no_checkpoint:
        cs.TRAIN_CKPT_DIR = None
    try:
        card = cs.phase_setup()
        if args.family == "train":
            cs.phase_backward_kernels()
            cs.phase_train(card)
        else:
            cs.phase_family(args.family, card)
    except Exception:                       # report, then fail the run
        traceback.print_exc()
        failed.append("raised")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
