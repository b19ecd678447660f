"""What the port's benchmarks (``benchmarks/torch_*.py``) share.

Not a benchmark: the suites import it.  It imports torch, numpy and
``repro_torch`` only, never JAX or the JAX package.

  * :func:`bench_main` — every suite's command line: ``--device`` (the
    CUDA card; ``cpu`` rehearses on the CPU), ``--json PATH``; without a
    card it prints "no CUDA device" and exits 2, never falling back to
    the CPU; it prints the card's name and power limit first, the result
    as one JSON object last, and exits 1 when a gate failed;
  * :func:`recompile_ms` — the recompile yardstick: a cold
    ``torch.compile(fullgraph=True, dynamic=False)`` of a DFG's
    ``evaluate`` with Inductor's FX-graph cache off and Inductor's and
    Triton's caches in a fresh directory under ``build/``, after
    :func:`warm_compiler` has paid the compiler's once-a-process set-up;
  * :func:`device_times` — device ms of a call: on the card, the L2
    evicted by a 100 MB read and the host's enqueue hidden by a sleep on
    the card before each CUDA-event window (on the CPU, the host clock);
  * :func:`executor_reading` — one program's image launched on the
    executor over stacked inputs, held bit for bit (NaN positions apart)
    against the expected outputs, and timed;
  * :class:`ModelledSession` — a Session whose modelled timeline is the
    same in every run.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.core.dfg import trace  # noqa: E402
from repro_torch.core.session import Session  # noqa: E402
from repro_torch.kernels.overlay_exec import kernel, ops  # noqa: E402

BUILD = ROOT / "build"
L2_FLUSH_BYTES = 100 << 20          # twice the H100's 50 MB L2
# the card sleeps this long before each timed window (about 0.5 ms at the
# H100's 1.98 GHz boost clock), longer than the host takes to enqueue
HIDE_HOST_CYCLES = 1_000_000


def card_line(device: str) -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    if torch.device(device).type == "cpu":
        return "cpu (no card)"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "not read"


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def same_bits(got, want) -> bool:
    """float32 bit equality with NaNs compared by position only (NaN
    payloads differ between numpy and the card)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if got.shape != want.shape:
        return False
    nan_g, nan_w = np.isnan(got), np.isnan(want)
    return bool(np.array_equal(nan_g, nan_w) and np.array_equal(
        got.view(np.int32)[~nan_g], want.view(np.int32)[~nan_w]))


def as_list(outs) -> List:
    """``run_reference``'s one array or tuple of arrays as a list."""
    return list(outs) if isinstance(outs, tuple) else [outs]


class ModelledSession(Session):
    """A Session on one build worker whose host clock stays at 0 µs, so
    every event time is the queues' model alone, the same in every run
    and in both packages: with the wall clock a launch chains on the
    wall-clock landing of its compile, and with parallel builds the order
    in which they land decides placements and configuration reuse."""

    def __init__(self, *args, **kw):
        kw["max_workers"] = 1
        super().__init__(*args, **kw)

    def now_us(self) -> float:
        return 0.0


# ------------------------------------------------------- compile yardstick

def fresh_dir(sub: str, tag: str) -> Path:
    """A new directory under ``build/<sub>/``."""
    (BUILD / sub).mkdir(parents=True, exist_ok=True)
    return Path(tempfile.mkdtemp(prefix=f"{tag}_", dir=BUILD / sub))


@contextlib.contextmanager
def compile_caches(sub: str):
    """Inductor's and Triton's caches in a fresh directory under
    ``build/<sub>/``, the FX-graph cache off, one compile thread (no
    worker process outlives the block); dynamo reset on entry and exit."""
    import torch._dynamo
    import torch._inductor.config as inductor_config

    cache = fresh_dir(sub, "inductor")
    env = {"TORCHINDUCTOR_CACHE_DIR": str(cache / "inductor"),
           "TRITON_CACHE_DIR": str(cache / "triton")}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        with inductor_config.patch(fx_graph_cache=False, compile_threads=1):
            torch._dynamo.reset()
            yield
    finally:
        torch._dynamo.reset()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(cache, ignore_errors=True)


def compile_dfg(dfg) -> Callable:
    """``torch.compile`` of ``dfg.evaluate`` over positional tensors."""
    return torch.compile(lambda *vs: tuple(dfg.evaluate(list(vs))),
                         fullgraph=True, dynamic=False)


def recompile_ms(dfg, *xs: torch.Tensor, sub: str = "recompile"
                 ) -> Dict[str, float]:
    """A cold ``torch.compile`` of ``dfg.evaluate`` on ``xs``: the first
    call minus a warm call, host ms ending in a synchronise, with every
    compile cache cold (:func:`compile_caches`)."""
    times = []
    with compile_caches(sub):
        compiled = compile_dfg(dfg)
        for _ in range(2):
            sync(xs[0].device)
            t0 = time.perf_counter()
            compiled(*xs)
            sync(xs[0].device)
            times.append((time.perf_counter() - t0) * 1e3)
    return dict(first_ms=times[0], warm_ms=times[1],
                compile_ms=times[0] - times[1])


def warm_compiler(recompile: Callable, x: torch.Tensor) -> None:
    """Pay the compiler's once-a-process set-up (imports, device queries)
    on a kernel that is none of those measured."""
    recompile(trace(lambda v: v * 0.5 + 0.25, 1, "warmup"), x)


# ------------------------------------------------------------------ timing

def device_times(fn: Callable, device, reps: int) -> List[float]:
    """ms of ``reps`` calls of ``fn`` after one untimed call.  On the
    card: CUDA events, each window after an L2-evicting read and a sleep
    that hides the host's enqueue.  On the CPU: the host clock."""
    dev = torch.device(device)
    fn()
    sync(dev)
    times = []
    if dev.type == "cpu":
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return times
    scratch = torch.zeros(L2_FLUSH_BYTES // 4, device=dev)
    for _ in range(reps):
        scratch.sum()
        torch.cuda._sleep(HIDE_HOST_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def stacked(xs: Sequence[np.ndarray], device) -> torch.Tensor:
    """Inputs as the executor's ``(n_in, N)`` float32 tensor on
    ``device``."""
    return torch.stack([torch.from_numpy(np.ascontiguousarray(a, np.float32))
                        for a in xs]).to(device)


def executor_reading(program, xs: Sequence[np.ndarray],
                     want: Sequence[np.ndarray], device, reps: int
                     ) -> Dict:
    """``program``'s image launched over ``xs`` on ``device`` (the CUDA
    executor on the card, its plain version on the CPU): its outputs
    against ``want`` bit for bit, then ``reps`` timed launches."""
    image = ops.load_image(program, torch.device(device))
    x = stacked(xs, device)
    got = kernel.overlay_execute(image, x)
    exact = len(want) == image.n_out and all(
        same_bits(got[j].cpu().numpy(), w) for j, w in enumerate(want))
    times = device_times(lambda: kernel.overlay_execute(image, x), device,
                         reps) if reps else []
    return dict(bit_exact=exact, items=int(x.shape[1]),
                ms=statistics.median(times) if times else None,
                ms_all=times)


def launch_checked(ck, n: int, device, seed: int = 0) -> bool:
    """One launch of ``ck``'s program on ``device`` over ``n`` seeded
    work-items per input, bit for bit against ``ck.run_reference``."""
    rng = np.random.default_rng(seed)
    xs = [rng.uniform(-1, 1, n).astype(np.float32)
          for _ in ck.dfg.inputs]
    return executor_reading(ck.program, xs, as_list(ck.run_reference(*xs)),
                            device, reps=0)["bit_exact"]


# ------------------------------------------------------------ command line

def bench_main(name: str, ap: argparse.ArgumentParser,
               argv: Optional[List[str]], run: Callable,
               report: Callable) -> int:
    """A suite's ``main``: ``run(device, **other arguments)`` and
    ``report(result)``; exits 2 without a card, 1 when a gate failed."""
    ap.add_argument("--device", default="cuda",
                    help="where the executor runs (default: the CUDA "
                         "card; cpu rehearses on the CPU)")
    ap.add_argument("--json", metavar="PATH", default=None)
    args = vars(ap.parse_args(argv))
    device, out = args.pop("device"), args.pop("json")
    if device != "cpu" and not torch.cuda.is_available():
        print(f"{name}: no CUDA device (pass --device cpu to rehearse on "
              f"the CPU)", file=sys.stderr)
        return 2
    print(card_line(device), flush=True)
    result = run(device, **args)
    report(result)
    for f in result["gate_failures"]:
        print(f"GATE FAILED: {f}", file=sys.stderr)
    if out:
        with open(out, "w") as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps(result))
    return 1 if result["gate_failures"] else 0
