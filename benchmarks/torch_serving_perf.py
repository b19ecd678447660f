#!/usr/bin/env python3
"""Continuous-batching serving on the port's Session, on one CUDA card.

    PYTHONPATH=src python3 benchmarks/torch_serving_perf.py \
        [--gate 2.0] [--device cuda] [--json out.json]

The port of ``benchmarks/serving_perf.py``: one deterministic bursty
three-family trace (transformer / mamba2 / moe tenants under the
realtime / standard / batch SLO classes, 36 requests in three bursts of
12, max batch 8) on two ``OverlaySpec(8, 8, 2)`` overlay devices, three
ways:

  * **sequential** — ``serve_sequential``: same graphs, same Session, no
    batching; the throughput baseline and the bit-identity reference;
  * **batched**    — ``InferenceServer`` with continuous batching;
  * **chaos**      — the batched path under a seeded ``FaultPlan``
    injecting about 5 % transient ``device_exec`` faults (the reference's
    seed and rate).

Every launch runs the CUDA overlay executor on states that stay on the
card (``--device cpu`` runs the executor's plain version on the CPU, for
a rehearsal).  All legs are warm: every graph is compiled before the
modelled clock's anchor ``t0`` is taken, on one build worker held until
every build is submitted, so each leg places its partitions the same way.

The four gates of the reference (the process exits 1 on any):

  1. throughput — sequential / batched modelled makespan >= ``--gate``;
  2. zero dropped — no leg rejects or loses a request;
  3. correctness — batched outputs bit-identical to sequential, chaos
     outputs bit-identical to the fault-free batched run;
  4. chaos proof — the chaos leg injected faults.

Beside the modelled makespans, which are the queues' model and equal the
JAX package's, it reads what the reference cannot: the host ms each leg
takes on the host clock (ending in a synchronise), and the device ms of
one decode iteration at max batch 8 by CUDA events with the host's
enqueue hidden.  The first line is ``nvidia-smi``'s name and power limit
of the card; the last line is one JSON object.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.core.faults import FaultPlan  # noqa: E402
from repro_torch.core.runtime import Device, OverlaySpec  # noqa: E402
from repro_torch.core.session import Session  # noqa: E402
from repro_torch.serve import (InferenceServer, Request,  # noqa: E402
                               serve_sequential)
from repro_torch.serve.models import PIPELINES, build_zoo  # noqa: E402

SPEC_KW = dict(width=8, height=8, dsp_per_fu=2)
N_DEVICES = 2
MAX_BATCH = 8
TENANTS = {"transformer": "realtime", "mamba2": "standard", "moe": "batch"}
N_REQUESTS = 36
BURST = 12
FAULT_SEED = 11
EXEC_FAULT_RATE = 0.05
# decode iterations timed by CUDA events, and the card's sleep that hides
# the host's enqueue before each
DEVICE_REPS = 50
HIDE_HOST_CYCLES = 1_000_000


def card_line(device: str) -> str:
    if device == "cpu":
        return "cpu (no card)"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "not read"


def make_trace(seed: int = 7) -> List[dict]:
    """``serving_perf.make_trace``: request kwargs, trace-ordered."""
    rng = np.random.default_rng(seed)
    fams = sorted(TENANTS)
    out = []
    for i in range(N_REQUESTS):
        fam = fams[i % len(fams)]
        out.append(dict(
            model=fam,
            prompt=rng.standard_normal(
                PIPELINES[fam].state_dim).astype(np.float32),
            decode_steps=int(rng.integers(4, 8)),
            offset_us=(i // BURST) * 40.0 + (i % BURST) * 2.0))
    return out


def _requests(trace: List[dict], t0: float) -> List[Request]:
    return [Request(kw["model"], kw["prompt"], kw["decode_steps"],
                    t_arrival_us=t0 + kw["offset_us"]) for kw in trace]


def _digest(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _session(device: str, plan: Optional[FaultPlan] = None) -> Session:
    spec = OverlaySpec(**SPEC_KW)
    return Session([Device(f"ovl{i}", spec) for i in range(N_DEVICES)],
                   faults=plan, max_workers=1, device=device)


def _warm(sess: Session, build):
    """``build()`` with its builds placed in submission order, all landed."""
    gate = threading.Event()
    held = sess._pool.submit(gate.wait, 300)
    try:
        out = build()
    finally:
        gate.set()
        held.result()
    sess._pool.submit(lambda: None).result()
    return out


def _sync(device: str) -> None:
    if device != "cpu":
        torch.cuda.synchronize()


def run_sequential(trace: List[dict], device: str) -> Dict:
    with _session(device) as sess:
        zoo = _warm(sess, lambda: build_zoo(sess, sorted(TENANTS)))
        t0 = sess.now_us()
        reqs = _requests(trace, t0)
        _sync(device)
        t_host = time.perf_counter()
        outputs, makespan = serve_sequential(sess, zoo, reqs)
        _sync(device)
        host_ms = (time.perf_counter() - t_host) * 1e3
        digests = [_digest(outputs[r.rid]) for r in reqs]
        for m in zoo.values():
            m.release()
    return dict(makespan_us=makespan - t0, requests=len(reqs), rejected=0,
                host_ms=host_ms, digests=digests)


def run_batched(trace: List[dict], device: str, chaos: bool) -> Dict:
    plan = (FaultPlan(seed=FAULT_SEED).add("device_exec",
                                           rate=EXEC_FAULT_RATE)
            if chaos else None)
    with _session(device, plan) as sess:
        srv = _warm(sess, lambda: InferenceServer(sess, TENANTS,
                                                  max_batch=MAX_BATCH))
        with srv:
            t0 = sess.now_us()
            reqs = _requests(trace, t0)
            _sync(device)
            t_host = time.perf_counter()
            admitted = sum(srv.submit(r) for r in reqs)
            makespan = srv.run()
            _sync(device)
            host_ms = (time.perf_counter() - t_host) * 1e3
            serving = sess.stats()["serving"]
            done = [r for r in reqs if r.output is not None]
            result = dict(
                chaos=chaos, makespan_us=makespan - t0,
                requests=len(done), admitted=admitted,
                rejected=serving["rejected"],
                degraded_steps=serving["degraded_steps"],
                iterations={name: m["iterations"]
                            for name, m in serving["models"].items()},
                occupancy={name: m["occupancy_ewma"]
                           for name, m in serving["models"].items()},
                latency_us=serving["latency_us"], host_ms=host_ms,
                digests=[_digest(r.output) for r in done])
            result["host_us_per_iteration"] = \
                host_ms * 1e3 / max(1, sum(result["iterations"].values()))
            if chaos:
                stats = sess.stats()
                result["faults"] = stats["faults"]
                result["recovery"] = {k: v for k, v in
                                      stats["recovery"].items()
                                      if k != "breakers"}
    return result


def device_ms_per_iteration(device: str) -> Optional[Dict]:
    """CUDA-event ms of one transformer decode iteration at MAX_BATCH (the
    card sleeps while the host enqueues it): median, fastest, slowest."""
    if device == "cpu":
        return None
    rng = np.random.default_rng(3)
    with _session(device) as sess:
        srv = _warm(sess, lambda: InferenceServer(
            sess, {"transformer": "realtime"}, max_batch=MAX_BATCH,
            iter_quantum=1))
        with srv:
            t0 = sess.now_us()
            for _ in range(MAX_BATCH):
                srv.submit(Request("transformer", rng.standard_normal(
                    64).astype(np.float32), decode_steps=1 << 30,
                    t_arrival_us=t0))
            for _ in range(3):
                srv.step()
            times = []
            for _ in range(DEVICE_REPS):
                torch.cuda._sleep(HIDE_HOST_CYCLES)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                srv.step()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
    return dict(median=statistics.median(times), fastest=min(times),
                slowest=max(times), work_items=MAX_BATCH * 64)


def bench(device: str) -> Dict:
    trace = make_trace()
    seq = run_sequential(trace, device)
    bat = run_batched(trace, device, chaos=False)
    cha = run_batched(trace, device, chaos=True)
    return dict(
        spec=SPEC_KW, devices=N_DEVICES, max_batch=MAX_BATCH,
        tenants=TENANTS, n_requests=N_REQUESTS, device=device,
        fault_seed=FAULT_SEED, exec_fault_rate=EXEC_FAULT_RATE,
        sequential=seq, batched=bat, chaos=cha,
        speedup=seq["makespan_us"] / max(bat["makespan_us"], 1e-9),
        bit_identical=(bat["digests"] == seq["digests"]),
        chaos_bit_identical=(cha["digests"] == bat["digests"]),
        all_complete=(bat["requests"] == N_REQUESTS and
                      cha["requests"] == N_REQUESTS),
        decode_device_ms=device_ms_per_iteration(device))


def check_gate(result: Dict, gate: float) -> List[str]:
    failures = []
    if result["speedup"] < gate:
        failures.append(
            f"batched speedup {result['speedup']:.3f}x below gate {gate}x")
    for key in ("sequential", "batched", "chaos"):
        if result[key]["rejected"]:
            failures.append(f"{key} run rejected "
                            f"{result[key]['rejected']} requests")
    if not result["all_complete"]:
        failures.append(
            f"dropped requests: batched completed "
            f"{result['batched']['requests']}, chaos completed "
            f"{result['chaos']['requests']} of {N_REQUESTS}")
    if not result["bit_identical"]:
        failures.append("batched outputs differ from the sequential oracle")
    if not result["chaos_bit_identical"]:
        failures.append("chaos outputs differ from the fault-free batched "
                        "run")
    if not result["chaos"]["faults"]["injected"]:
        failures.append("chaos leg injected no faults")
    return failures


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gate", type=float, default=2.0,
                    help="min sequential/batched modelled makespan ratio "
                         "(default 2.0; <= 0 disables gating)")
    ap.add_argument("--device", default="cuda",
                    help="where the Sessions run (default: the CUDA card)")
    ap.add_argument("--json", metavar="PATH", default=None)
    args = ap.parse_args()
    if args.device != "cpu" and not torch.cuda.is_available():
        print("torch_serving_perf: no CUDA device (pass --device cpu to "
              "rehearse on the CPU)", file=sys.stderr)
        return 2
    card = card_line(args.device)
    print(card, flush=True)
    result = bench(args.device)
    result["card"] = card
    for key in ("sequential", "batched", "chaos"):
        r = result[key]
        print(f"{key:<10} modelled makespan {r['makespan_us']:>10.3f} us  "
              f"({r['requests']} requests, {r['rejected']} rejected); host "
              f"{r['host_ms']:.3f} ms")
    bat, cha = result["batched"], result["chaos"]
    print(f"batched: {sum(bat['iterations'].values())} iterations, "
          f"{bat['host_us_per_iteration']:.1f} us host per iteration")
    print(f"chaos: injected {cha['faults']['injected']}, "
          f"degraded_steps={cha['degraded_steps']}")
    dev = result["decode_device_ms"]
    if dev is not None:
        print(f"decode iteration at max batch {MAX_BATCH} "
              f"({dev['work_items']} work-items): {dev['median']:.4f} ms "
              f"device ({dev['fastest']:.4f}-{dev['slowest']:.4f}, "
              f"{DEVICE_REPS} CUDA-event windows); {card}")
    print(f"speedup {result['speedup']:.3f}x, "
          f"bit_identical={result['bit_identical']}, "
          f"chaos_bit_identical={result['chaos_bit_identical']}, "
          f"all_complete={result['all_complete']}")
    failures = check_gate(result, args.gate) if args.gate > 0 else []
    result["gate"] = args.gate
    result["gate_failures"] = failures
    for f in failures:
        print(f"GATE FAILED: {f}", file=sys.stderr)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps({k: v for k, v in result.items()
                      if k not in ("sequential", "batched", "chaos")}
                     | {k: {kk: vv for kk, vv in result[k].items()
                            if kk != "digests"}
                        for k in ("sequential", "batched", "chaos")}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
