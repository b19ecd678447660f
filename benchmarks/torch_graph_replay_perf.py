#!/usr/bin/env python3
"""Graph capture and fused replay on the port's Session, on one CUDA card.

    PYTHONPATH=src python3 benchmarks/torch_graph_replay_perf.py \
        [--gate 1.0] [--device cuda] [--json out.json]

The port of ``benchmarks/graph_replay_perf.py``: one tenant's six-stage
pointwise pipeline (two paper kernels and four recorded stages) served for
four requests of 200,000 work-items, two ways on identical one-device
fleets (``OverlaySpec(8, 8, 2)``, ``CompileOptions(max_replicas=4)``):

  * **nodewise** — every stage compiled and enqueued on its own
    (``Session.launch_nodewise``);
  * **graph** — the pipeline captured once, instantiated into fused
    overlay configurations and launched per request (``Session.launch``).

The reference's four gates hold (the process exits 1 on any):

  1. the modelled configuration charges drop by at least ``--gate`` times
     the partition ratio K/P;
  2. the modelled fleet makespan is never worse (``--gate`` times);
  3. the outputs are identical, bit for bit;
  4. re-instantiating the served graph runs no compiler stage.

The charges and makespans are the queues' model.  Unlike the reference,
the Sessions hold their host clock at 0 µs and build on one worker, so
the model is all they hold: with the wall clock, each execution chains on
the wall-clock landing of its compile, the makespan is mostly compile
time, and the reference's own makespan gate read 0.951-1.079 in four runs
on one host; how many configurations the nodewise path could reuse also
depended on when its six compiles landed.  On the card the
benchmark also reads what the reference cannot: per replay, fused against
nodewise, at 200,000 and at 2^24 work-items, the host µs of a
``Session.launch`` (the median of ``REPS`` calls after as many warm ones)
and its device ms (CUDA events, the card asleep while the host enqueues),
and the executor launches it makes: P against K.  The first line is the
card's name and power limit; the last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

import port_bench  # noqa: E402
import torch  # noqa: E402
from port_bench import ModelledSession  # noqa: E402

from repro_torch.configs.paper_suite import BENCHMARKS  # noqa: E402
from repro_torch.core.cache import JITCache  # noqa: E402
from repro_torch.core.options import CompileOptions  # noqa: E402
from repro_torch.core.overlay import OverlaySpec  # noqa: E402
from repro_torch.core.runtime import Buffer, Device  # noqa: E402
from repro_torch.core.session import Session  # noqa: E402
from repro_torch.kernels.overlay_exec import kernel  # noqa: E402

SPEC_KW = dict(width=8, height=8, dsp_per_fu=2)
OPTS = CompileOptions(max_replicas=4)
N_ITEMS = 200_000
N_REQUESTS = 4
# the replay readings: work-items per request, and replays timed per
# reading (after as many untimed)
TIMED_ITEMS = (N_ITEMS, 1 << 24)
REPS = 50
# the card's sleep before each CUDA-event window must outlast the host's
# enqueue, which drifts within a run: four times the host's median, at up
# to 2,000 cycles a microsecond (the H100's boost clock is 1.98 GHz)
CYCLES_PER_US = 2_000

# the serving pipeline: K distinct small stages = K distinct configurations
# (two paper kernels + four recorded pointwise stages), the reference's
STAGES = [
    ("poly1", BENCHMARKS["poly1"][0]),
    ("cheb", BENCHMARKS["chebyshev"][0]),
    ("scale", lambda x: x * 0.125 + 0.5),
    ("sq", lambda x: x * x - 1.0),
    ("mix", lambda x: x * 0.75 + x * x * 0.25),
    ("out", lambda x: x * 2.0 - 3.0),
]


def _capture(sess: Session):
    with sess.capture("tenant-a", name="serve_pipe") as g:
        buf = g.input("x")
        for name, src in STAGES:
            buf = g.call(src, OPTS.replace(n_inputs=1, name=name), buf)
    return g


def _session(device: str) -> Session:
    return ModelledSession([Device("ovl0", OverlaySpec(**SPEC_KW))],
                           cache=JITCache(capacity=64), device=device)


def _run(mode: str, device: str):
    """Serve the trace in ``mode`` ("graph" | "nodewise"); the modelled
    metrics and each request's (input, output)."""
    rng = np.random.default_rng(0)
    with _session(device) as sess:
        g = _capture(sess)
        gx = sess.instantiate(g) if mode == "graph" else None
        outs = []
        for _ in range(N_REQUESTS):
            x = rng.uniform(-1, 1, N_ITEMS).astype(np.float32)
            ev = sess.launch(gx, x) if mode == "graph" else \
                sess.launch_nodewise(g, x)
            outs.append((x, np.asarray(ev.wait()[0].read(), np.float32)))
        charges = sess.config_charges()
        makespan = max(c.engine_end_us for c in sess.contexts.values())
        result = dict(
            mode=mode, stages=len(STAGES), requests=N_REQUESTS,
            partitions=gx.n_partitions if gx is not None else len(STAGES),
            config_charges=charges["charges"],
            config_us=round(charges["config_us"], 2),
            makespan_us=round(makespan, 1),
            compile_misses=sess.cache.stats.misses)
        if gx is not None:
            # repeat instantiation at the same fleet state must be a warm
            # cache hit: release the exec, re-instantiate, no compiler stage
            gx.release()
            misses = sess.cache.stats.misses
            sess.instantiate(g).result()
            result["reinstantiate_misses"] = sess.cache.stats.misses - misses
        return result, outs


def bench(device: str = "cuda") -> Dict:
    """The reference's ``bench()``: both modes on fresh fleets, compared."""
    graph, outs_g = _run("graph", device)
    node, outs_n = _run("nodewise", device)
    identical = all(np.array_equal(og.view(np.int32), on.view(np.int32))
                    for (_, og), (_, on) in zip(outs_g, outs_n))
    k, p = len(STAGES), graph["partitions"]
    return dict(
        spec=SPEC_KW, items=N_ITEMS, requests=N_REQUESTS,
        stages=[name for name, _ in STAGES],
        graph=graph, nodewise=node,
        partition_ratio=round(k / p, 3),
        charge_ratio=round(node["config_charges"] /
                           max(graph["config_charges"], 1), 3),
        makespan_ratio=round(node["makespan_us"] /
                             max(graph["makespan_us"], 1e-9), 3),
        identical_results=identical)


def check_gate(result: Dict, gate: float) -> List[str]:
    """The reference's four gates."""
    failures = []
    want = gate * result["partition_ratio"]
    if result["charge_ratio"] < want:
        failures.append(
            f"config charges only cut {result['charge_ratio']}x, below the "
            f"partition ratio {want}x "
            f"({result['nodewise']['config_charges']} vs "
            f"{result['graph']['config_charges']} charges)")
    if result["makespan_ratio"] < gate:
        failures.append(
            f"graph replay makespan ratio {result['makespan_ratio']}x < "
            f"{gate}x (graph {result['graph']['makespan_us']} vs nodewise "
            f"{result['nodewise']['makespan_us']} us)")
    if not result["identical_results"]:
        failures.append("graph replay and node-at-a-time outputs differ")
    if result["graph"].get("reinstantiate_misses", 0) != 0:
        failures.append(
            f"re-instantiation ran {result['graph']['reinstantiate_misses']}"
            f" compiler stages (expected a warm cache hit)")
    return failures


def _host_us(call, drain) -> float:
    """Median host µs of ``call`` over REPS calls, after REPS untimed ones
    (the allocator then holds the outputs' memory); the card synchronised
    and the queue drained after each pass."""
    for _ in range(2):
        times = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            call()
            times.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
        drain()
    return statistics.median(times)


def _device_ms(call, drain, host_us: float) -> float:
    """Median CUDA-event ms of ``call``, the card asleep while the host
    enqueues it (``host_us``: the host's median time of a call)."""
    times = []
    for _ in range(REPS):
        torch.cuda._sleep(int(4 * host_us * CYCLES_PER_US))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    drain()
    return statistics.median(times)


def replay_times(n: int) -> Dict:
    """Fused against nodewise replay of the pipeline at ``n`` work-items on
    the card: host µs and device ms per replay, executor launches per
    replay, and the two outputs bit for bit."""
    rng = np.random.default_rng(1)
    with _session("cuda") as sess:
        g = _capture(sess)
        gx = sess.instantiate(g).result()
        x = Buffer(rng.uniform(-1, 1, n).astype(np.float32))
        queue = sess.queue_for(g.tenant, "ovl0")
        calls = {"graph": lambda: sess.launch(gx, x),
                 "nodewise": lambda: sess.launch_nodewise(g, x)}
        out = {}
        for mode, call in calls.items():
            before = kernel.overlay_execute.launches
            y = call().wait()[0].data
            launches = kernel.overlay_execute.launches - before
            host_us = _host_us(call, queue.drain)
            out[mode] = dict(launches=launches, host_us=host_us,
                             device_ms=_device_ms(call, queue.drain,
                                                  host_us),
                             output=y)
        same = torch.equal(out["graph"].pop("output").view(torch.int32),
                           out["nodewise"].pop("output").view(torch.int32))
        return dict(items=n, partitions=gx.n_partitions, stages=len(g.nodes),
                    bit_identical=same, **out)


def run(device: str = "cuda", gate: float = 1.0) -> Dict:
    """``bench`` with the card's replay readings and the gates' failures."""
    result = bench(device)
    result["card"] = port_bench.card_line(device)
    failures = check_gate(result, gate)
    result["replay"] = []
    if device != "cpu":
        for n in TIMED_ITEMS:
            r = replay_times(n)
            result["replay"].append(r)
            if not r["bit_identical"]:
                failures.append(f"fused and nodewise replay differ at N={n}")
            if (r["graph"]["launches"], r["nodewise"]["launches"]) != \
                    (r["partitions"], r["stages"]):
                failures.append(
                    f"N={n}: {r['graph']['launches']} launches fused for "
                    f"{r['partitions']} partitions, "
                    f"{r['nodewise']['launches']} nodewise for "
                    f"{r['stages']} stages")
    result["gate"] = gate
    result["gate_failures"] = failures
    return result


def rows(result: Dict) -> List[Dict]:
    """The reference's CSV rows, then the card's replay readings."""
    out = [dict(
        name=f"graph_replay/{key}",
        us_per_call=result[key]["makespan_us"],
        derived=(f"{result[key]['config_charges']} config charges "
                 f"({result[key]['config_us']}us) over "
                 f"{result[key]['requests']} requests x "
                 f"{result[key]['stages']} stages, "
                 f"{result[key]['partitions']} partitions"))
        for key in ("graph", "nodewise")]
    out.append(dict(
        name="graph_replay/ratio", us_per_call=0.0,
        derived=(f"config charges cut {result['charge_ratio']}x "
                 f"(partition ratio {result['partition_ratio']}x), "
                 f"makespan {result['makespan_ratio']}x, "
                 f"identical={result['identical_results']}")))
    out += [dict(
        name=f"graph_replay/replay@{r['items']}",
        us_per_call=r["graph"]["host_us"],
        derived=(f"fused {r['graph']['device_ms']:.4f}ms device "
                 f"{r['graph']['launches']} launches, nodewise "
                 f"{r['nodewise']['host_us']:.1f}us host "
                 f"{r['nodewise']['device_ms']:.4f}ms device "
                 f"{r['nodewise']['launches']} launches"))
        for r in result["replay"]]
    return out


def report(result: Dict) -> None:
    card = result["card"]
    for key in ("graph", "nodewise"):
        r = result[key]
        print(f"{key:<9} modelled makespan {r['makespan_us']:>10.1f} us  "
              f"{r['config_charges']:>3} config charges "
              f"({r['config_us']:.1f} us)  {r['compile_misses']} cold builds")
    print(f"partitions: {result['graph']['partitions']} for "
          f"{result['graph']['stages']} stages (partition ratio "
          f"{result['partition_ratio']}x); config charges cut "
          f"{result['charge_ratio']}x, makespan {result['makespan_ratio']}x, "
          f"identical results: {result['identical_results']}")
    for r in result["replay"]:
        g, nw = r["graph"], r["nodewise"]
        print(f"replay at N={r['items']}: fused {g['host_us']:.1f} us host, "
              f"{g['device_ms']:.4f} ms device, {g['launches']} launch(es); "
              f"nodewise {nw['host_us']:.1f} us host, "
              f"{nw['device_ms']:.4f} ms device, {nw['launches']} launches; "
              f"bit-identical {r['bit_identical']}; {card}")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gate", type=float, default=1.0,
                    help="charges cut >= GATE x the partition ratio and "
                         "makespan ratio >= GATE (default 1.0, the "
                         "reference's acceptance bound)")
    ap.add_argument("--device", default="cuda",
                    help="where the Sessions run (default: the CUDA card)")
    ap.add_argument("--json", metavar="PATH", default=None)
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        print("torch_graph_replay_perf: no CUDA device (pass --device cpu "
              "to rehearse on the CPU)", file=sys.stderr)
        return 2
    print(port_bench.card_line(args.device), flush=True)
    result = run(args.device, args.gate)
    report(result)
    for f in result["gate_failures"]:
        print(f"GATE FAILED: {f}", file=sys.stderr)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps(result))
    return 1 if result["gate_failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
