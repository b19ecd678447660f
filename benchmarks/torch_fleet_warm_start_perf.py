#!/usr/bin/env python3
"""Fleet-wide warm start through the remote cache tier and compile farm,
the fleet's artifacts launched on one CUDA card.

    PYTHONPATH=src python3 benchmarks/torch_fleet_warm_start_perf.py \
        [--hosts 200] [--tenants 2000] [--requests 6000] [--gate 2.0] \
        [--device cuda] [--json out.json]

The port of ``benchmarks/fleet_warm_start_perf.py``: hundreds of serving
hosts, thousands of tenants, one deterministic churn trace (tenant-affine
routing with 5 % churn, rolling restarts), under four scenarios:

  * **disk-only**  — per-host disk caches, nothing shared;
  * **remote**     — the shared ``RemoteCache`` tier and a ``CompileFarm``
    prefetching the predicted-hot half of the pairs;
  * **fresh-host** — a new host joins the warm fleet;
  * **chaos**      — the remote scenario under a seeded ``FaultPlan`` (5 %
    lost reads, writes and farm calls, 0.5 % corrupt payloads) and a total
    remote outage over the trace's third quarter.

Hosts are simulated at the cache level: the distinct artifacts (the paper
suite at two replica budgets on ``OverlaySpec(8, 8, 2)``) are built once
with the real pipeline, and a host's cold compile inserts the prebuilt
artifact and charges a fixed modelled build time, so the makespans are
the model's.  The reference's gates (the process exits 1 on any): a fresh
host joining the warm fleet compiles nothing cold; the remote tier cuts
global cold compiles at least 10x against disk-only; under chaos every
request completes with the fault-free scenario's artifact and the fleet
makespan stays within ``--gate`` (2.0) times fault-free, with faults
injected.  The chaos scenario's breakers half-open after a wall-clock
cooldown, as in the reference, so its counts vary from run to run.

Beyond the reference: each distinct artifact is launched once on the card
over 2^20 work-items, bit for bit against ``run_reference``.
"""

from __future__ import annotations

import argparse
import hashlib
import shutil
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

sys.path.insert(0, str(Path(__file__).resolve().parent))

import port_bench  # noqa: E402

from repro_torch.configs.paper_suite import BENCHMARKS  # noqa: E402
from repro_torch.core import faults as faults_mod  # noqa: E402
from repro_torch.core.cache import JITCache, make_cache_key  # noqa: E402
from repro_torch.core.faults import FaultPlan  # noqa: E402
from repro_torch.core.jit import jit_compile, lower_to_dfg  # noqa: E402
from repro_torch.core.options import CompileOptions  # noqa: E402
from repro_torch.core.overlay import OverlaySpec  # noqa: E402
from repro_torch.core.recovery import RetryPolicy  # noqa: E402
from repro_torch.core.remote import (  # noqa: E402
    CompileFarm, RemoteBlobStore, RemoteCache, RemoteEndpoint)

SPEC = OverlaySpec(width=8, height=8, dsp_per_fu=2)
FAULT_SEED = 11
NET_FAULT_RATE = 0.05           # lost remote reads/writes, farm-RPC drops
CORRUPT_RATE = 0.005            # torn payloads (the quarantine path)
# modelled per-request serving charges (µs); a cold build charges a fixed
# modelled time, so every makespan is the same on any machine
MEM_HIT_US = 20.0
DISK_HIT_US = 400.0
REMOTE_HIT_US = 2_500.0
COLD_BUILD_US = 10_000.0
N_LAUNCH = 1 << 20

#: the fleet's distinct (kernel, CompileOptions) pairs: the paper suite at
#: two replica budgets; the farm prefetches the r4 half
PAIRS: List[Tuple[str, CompileOptions]] = [
    (name, CompileOptions(max_replicas=r))
    for name in sorted(BENCHMARKS) for r in (4, 2)]
HOT_PAIRS = [p for p in PAIRS if p[1].max_replicas == 4]


def _pick(seed: str, n: int) -> int:
    """Deterministic uniform pick in [0, n)."""
    h = hashlib.sha256(seed.encode()).digest()
    return int.from_bytes(h[:8], "big") % n


class Ref:
    """One distinct artifact: its fleet-wide key, the prebuilt
    CompiledKernel, its bitstream hash, and its measured build µs."""

    def __init__(self, key, ck, build_us: float):
        self.key = key
        self.ck = ck
        self.sha = ck.bitstream.sha256()
        self.build_us = build_us


def build_reference() -> Dict[int, Ref]:
    """Every distinct pair built once with the real pipeline."""
    refs: Dict[int, Ref] = {}
    builder = JITCache()
    for i, (name, opts) in enumerate(PAIRS):
        src = BENCHMARKS[name][0]
        t0 = time.perf_counter()
        ck = jit_compile(src, SPEC, opts=opts, cache=builder)
        build_us = (time.perf_counter() - t0) * 1e6
        g = lower_to_dfg(src, opts.n_inputs, opts.name, parse_source=True)
        key = make_cache_key(g, SPEC, free_fus=SPEC.n_fus,
                             free_io=SPEC.n_io, opts=opts)
        if builder.get(key) is not ck:
            raise RuntimeError("fleet key derivation drifted from the "
                               "pipeline's")
        refs[i] = Ref(key, ck, build_us)
    return refs


class Host:
    """One serving host: its JITCache (memory and its own disk directory),
    the shared remote tier if any, and a modelled busy clock."""

    def __init__(self, hid: int, root: Path, remote: Optional[RemoteCache]):
        self.hid = hid
        self.dir = root / f"host{hid:03d}"
        self.remote = remote
        self.busy_us = 0.0
        self.cold = 0
        self.restart()

    def restart(self) -> None:
        """A process restart: the memory tier goes, the disk stays."""
        self.cache = JITCache(persist_dir=self.dir, remote=self.remote)

    def serve(self, ref: Ref) -> str:
        """One request for one pair → the served bitstream's sha256."""
        before = (self.cache.stats.disk_hits, self.cache.stats.remote_hits)
        ck = self.cache.get(ref.key)
        if ck is None:
            self.cold += 1
            self.busy_us += COLD_BUILD_US
            self.cache.put(ref.key, ref.ck)
            return ref.sha
        if self.cache.stats.remote_hits > before[1]:
            self.busy_us += REMOTE_HIT_US
        elif self.cache.stats.disk_hits > before[0]:
            self.busy_us += DISK_HIT_US
        else:
            self.busy_us += MEM_HIT_US
        return ck.bitstream.sha256()


def make_remote() -> Tuple[RemoteBlobStore, RemoteCache]:
    store = RemoteBlobStore()
    endpoints = [RemoteEndpoint(store, f"region{i}", seed=FAULT_SEED + i)
                 for i in range(2)]
    # short breaker cooldown: the post-outage tail half-opens and re-closes
    # the breakers within the run
    return store, RemoteCache(endpoints,
                              retry=RetryPolicy(breaker_cooldown_s=0.01))


def replay(refs: Dict[int, Ref], root: Path, n_hosts: int, n_tenants: int,
           n_requests: int, with_remote: bool, chaos: bool,
           label: str) -> Dict:
    """The churn trace once → the scenario's accounting."""
    remote = farm = plan = None
    if with_remote:
        _store, remote = make_remote()
        farm = CompileFarm(SPEC, remote)
        for name, opts in HOT_PAIRS:            # fleet demand history
            farm.observe(BENCHMARKS[name][0], opts, weight=2)
    if chaos:
        # the corrupt rule first: rules on one stage share a decision hash
        # and the first firing rule wins
        plan = (FaultPlan(seed=FAULT_SEED)
                .add("remote_read", kind="corrupt", rate=CORRUPT_RATE)
                .add("remote_read", rate=NET_FAULT_RATE)
                .add("remote_write", rate=NET_FAULT_RATE)
                .add("farm_rpc", rate=NET_FAULT_RATE))
    with faults_mod.activate(plan):
        if farm is not None:
            farm.prefetch_hot(top_n=len(HOT_PAIRS))
        hosts = [Host(h, root, remote) for h in range(n_hosts)]
        outage = (n_requests // 2, (3 * n_requests) // 4) if chaos else None
        hashes: List[str] = []
        failures = 0
        for i in range(n_requests):
            if outage and i == outage[0]:
                for ep in remote.endpoints:     # total remote outage
                    ep.fail()
            if outage and i == outage[1]:
                for ep in remote.endpoints:     # the network heals
                    ep.recover()
            if i and i % 500 == 0:              # rolling restarts
                hosts[_pick(f"restart:{i}", n_hosts)].restart()
            tenant = _pick(f"tenant:{i}", n_tenants)
            ref = refs[tenant % len(refs)]      # tenant-affine demand
            hid = tenant % n_hosts              # tenant-affine routing
            if _pick(f"churn:{i}", 100) < 5:    # with 5 % churn
                hid = _pick(f"rebal:{i}", n_hosts)
            try:
                hashes.append(hosts[hid].serve(ref))
            except Exception:                   # noqa: BLE001 - the gate
                failures += 1
                hashes.append("FAILED")
    cold = sum(h.cold for h in hosts)
    out = dict(label=label, requests=n_requests, hosts=n_hosts,
               cold_compiles=cold, cold_rate=cold / n_requests,
               failures=failures,
               makespan_us=max(h.busy_us for h in hosts), hashes=hashes)
    if remote is not None:
        out["remote"] = remote.stats_dict()
        out["farm"] = farm.stats_dict()
    if plan is not None:
        out["faults"] = plan.as_dict()
    return out


def fresh_host_join(refs: Dict[int, Ref], root: Path) -> Dict:
    """A new host with empty local tiers serves every already-built pair
    from a warm fleet store."""
    _store, remote = make_remote()
    seeder = JITCache(remote=remote)
    for ref in refs.values():
        seeder.put(ref.key, ref.ck)
    fresh = Host(999, root, remote)
    shas = [fresh.serve(ref) for ref in refs.values()]
    return dict(label="fresh-host", pairs=len(refs),
                cold_compiles=fresh.cold,
                remote_hits=fresh.cache.stats.remote_hits,
                served_built=shas == [r.sha for r in refs.values()])


def run(device: str = "cuda", hosts: int = 200, tenants: int = 2000,
        requests: int = 6000, gate: float = 2.0) -> Dict:
    """The four scenarios, the launches and the gates."""
    refs = build_reference()
    results: Dict[str, Dict] = {}
    root = port_bench.fresh_dir("fleet_warm_start", "fleet")
    try:
        for label, with_remote, chaos in (("disk-only", False, False),
                                          ("remote", True, False),
                                          ("chaos", True, True)):
            results[label] = replay(refs, root / label, hosts, tenants,
                                    requests, with_remote, chaos, label)
        results["fresh-host"] = fresh_host_join(refs, root / "fresh")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    failures = []
    fh = results["fresh-host"]
    if fh["cold_compiles"] != 0 or not fh["served_built"]:
        failures.append(f"fresh host cold-compiled {fh['cold_compiles']} "
                        f"already-built pairs")
    cold_disk = results["disk-only"]["cold_compiles"]
    cold_remote = results["remote"]["cold_compiles"]
    reduction = cold_disk / max(cold_remote, 1)
    if cold_disk < 10 * max(cold_remote, 1):
        failures.append(f"cold reduction {reduction:.1f}x < 10x")
    ff, ch = results["remote"], results["chaos"]
    if ch["failures"]:
        failures.append(f"{ch['failures']} requests failed under chaos")
    if ch["hashes"] != ff["hashes"]:
        bad = sum(1 for a, b in zip(ff["hashes"], ch["hashes"]) if a != b)
        failures.append(f"{bad} chaos responses not bit-identical to "
                        f"fault-free")
    ratio = ch["makespan_us"] / max(ff["makespan_us"], 1e-9)
    if ratio > gate:
        failures.append(f"chaos makespan {ratio:.2f}x > {gate}x")
    if not ch["faults"]["injected"]:
        failures.append("the chaos run injected nothing")
    exact = [port_bench.launch_checked(ref.ck, N_LAUNCH, device)
             for ref in refs.values()]
    if not all(exact):
        failures.append(f"{exact.count(False)} of {len(exact)} artifact "
                        f"launches differ from run_reference")
    for r in results.values():       # per-request hashes: one digest each
        if "hashes" in r:
            r["hashes_sha256"] = hashlib.sha256(
                "\n".join(r.pop("hashes")).encode()).hexdigest()
    return dict(
        pairs=len(refs), hosts=hosts, tenants=tenants, requests=requests,
        device=device, gate=gate, cold_reduction=reduction,
        chaos_makespan_ratio=ratio, scenarios=results,
        mean_build_ms=sum(r.build_us for r in refs.values()) / len(refs)
        / 1e3,
        launches=len(exact), launch_items=N_LAUNCH,
        launches_bit_exact=all(exact),
        card=port_bench.card_line(device), gate_failures=failures)


def rows(result: Dict) -> List[Dict]:
    """The reference's CSV rows."""
    out = [dict(name=f"fleet/{label}/makespan",
                us_per_call=sc["makespan_us"],
                derived=f"{sc['cold_compiles']} cold, "
                        f"{sc['failures']} failures")
           for label, sc in result["scenarios"].items()
           if "makespan_us" in sc]
    out.append(dict(name="fleet/cold_reduction",
                    us_per_call=result["cold_reduction"],
                    derived=f"{result['cold_reduction']:.0f}x fewer cold "
                            f"compiles than disk-only"))
    out.append(dict(name="fleet/chaos_makespan_ratio",
                    us_per_call=result["chaos_makespan_ratio"],
                    derived=f"chaos <= {result['chaos_makespan_ratio']:.2f}"
                            f"x fault-free, all bit-identical"))
    out.append(dict(name="fleet/fresh_host_cold",
                    us_per_call=float(
                        result["scenarios"]["fresh-host"]["cold_compiles"]),
                    derived="fresh host joining warm fleet: zero cold"))
    return out


def report(result: Dict) -> None:
    print(f"reference set: {result['pairs']} distinct (kernel, opts) "
          f"pairs, mean real build {result['mean_build_ms']:.1f} ms")
    for label, r in result["scenarios"].items():
        if "makespan_us" not in r:
            continue
        extra = ""
        if "remote" in r:
            rs = r["remote"]
            extra = (f", remote {rs['hits']}h/{rs['misses']}m "
                     f"{rs['quarantined']}q {rs['degraded']}deg")
        print(f"{label:<10}: {r['cold_compiles']:5d} cold "
              f"({100 * r['cold_rate']:.2f}%), makespan "
              f"{r['makespan_us'] / 1e3:8.1f} ms, {r['failures']} "
              f"failures{extra}")
    fh = result["scenarios"]["fresh-host"]
    print(f"fresh-host: {fh['cold_compiles']} cold over {fh['pairs']} "
          f"already-built pairs ({fh['remote_hits']} remote hits)")
    print(f"cold-compile reduction {result['cold_reduction']:.0f}x; chaos "
          f"makespan ratio {result['chaos_makespan_ratio']:.2f}x (gate <= "
          f"{result['gate']}x); {result['launches']} artifacts launched over "
          f"{result['launch_items']} work-items, bit-exact "
          f"{result['launches_bit_exact']}; {result['card']}")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hosts", type=int, default=200)
    ap.add_argument("--tenants", type=int, default=2000)
    ap.add_argument("--requests", type=int, default=6000)
    ap.add_argument("--gate", type=float, default=2.0,
                    help="max chaos/fault-free makespan ratio")
    return port_bench.bench_main("torch_fleet_warm_start_perf", ap, argv,
                                 run, report)


if __name__ == "__main__":
    sys.exit(main())
