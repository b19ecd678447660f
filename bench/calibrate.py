"""Read a cell's compared numbers over many seeds in one process: the
program's (the lower readings of its limits) and the control's (the upper
readings), as the limits in ``limits/<workload>.json`` were set.

    python3 bench/calibrate.py --workload <name> --seeds 1,2,3 --seconds 3
        [--control fp8|fp8_attn] [--out file.jsonl]

``--control`` reads the reference in that float8 mode in the program's
place beside each seed's run.
One JSON line a seed.  Not run by the benchmark's runs."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import ROOT, environment  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", choices=("fp8", "fp8_attn"), default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    environment()
    import torch
    from bench import harness
    from bench.spec import Spec
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    spec = Spec(ROOT)
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        cell = harness.make_cell(spec, args.workload, seed, args.seconds,
                                 False, "cuda", t0,
                                 control=args.control)
        res = harness.run_cell(cell)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "numbers": res.numbers,
                           "control": res.control, "e2e": res.e2e,
                           "setup_s": res.setup_s,
                           "check_s": time.perf_counter() - t0
                           - res.setup_s - args.seconds,
                           "memory_peak": res.memory_peak,
                           "notes": res.notes})
        print(line, flush=True)
        if out:
            print(line, file=out, flush=True)
        del cell, res
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    print("forbidden modules:", harness.forbidden_modules(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
