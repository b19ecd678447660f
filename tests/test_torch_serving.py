"""The port's continuous-batching server against the JAX package's.

Each claim of ``tests/test_serve.py`` (and the two fast tests of
``tests/test_launch_serve.py``) runs the same seeded trace through
``repro.serve`` and ``repro_torch.serve`` on the same numpy inputs.  What
must be equal, exactly: every request's final state (bit for bit — the
port's Session runs the executor's plain version on the CPU, ``repro``'s
runs ``run_reference`` in numpy), every modelled latency and makespan,
the ``stats()["serving"]`` section, configuration charges and the
recovery and fault counters.

Two things make the modelled timeline the same in both packages and in
every run (``torch_runtime_pair``): the Sessions build on one worker held
until every build is submitted (``ordered_builds``), so each partition is
placed in the same order against the same bookings, and their host clock
is frozen at 0 (``freeze_clock``), so compile events add no wall time to
the timeline.  A test that needs the host clock (the launcher's own
Session) compares everything but the latencies.

The port keeps every state on its Session's device between steps
(``test_states_stay_on_the_session_device``); the card-only legs at the
end serve the same traces on the CUDA card against the CPU port.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.overlay_exec import ops
from torch_runtime_pair import (R, T, both, modelled_session,
                                ordered_builds)

pytestmark = pytest.mark.filterwarnings("ignore::RuntimeWarning",
                                        "ignore::DeprecationWarning")


def gpu(fn):
    """Needs a CUDA card: decided when the test runs, not at import."""
    fn = pytest.mark.skipif("not torch.cuda.is_available()",
                            reason="needs a CUDA card")(fn)
    return pytest.mark.gpu(fn)


def two_devices(pkg):
    return [pkg.Device("a", pkg.spec()), pkg.Device("b", pkg.spec())]


def session(pkg, devices=None, **kw):
    return modelled_session(pkg, devices or two_devices(pkg), **kw)


def server(pkg, sess, models, **kw):
    with ordered_builds(sess):
        return pkg.serve.InferenceServer(sess, models, **kw)


def zoo(pkg, sess, families, **kw):
    with ordered_builds(sess):
        return pkg.serve.build_zoo(sess, families, **kw)


def make_trace(pkg, families, n, seed=7, spread_us=10.0, steps=(4, 7)):
    """``tests/test_serve.py``'s deterministic trace: Request kwargs."""
    rng = np.random.default_rng(seed)
    lo, hi = steps
    out = []
    for i in range(n):
        fam = families[i % len(families)]
        out.append(dict(model=fam,
                        prompt=rng.standard_normal(
                            pkg.serve.PIPELINES[fam].state_dim
                        ).astype(np.float32),
                        decode_steps=lo + (i % (hi - lo + 1)),
                        t_arrival_us=float(i) * spread_us))
    return out


def bits(a) -> bytes:
    """A state vector's float32 words (a host array in either package)."""
    assert isinstance(a, np.ndarray) and a.dtype == np.float32
    return a.tobytes()


def served(pkg, sess, reqs, makespan=None) -> dict:
    """What a served trace shares with the other package's."""
    return dict(outputs=[bits(r.output) for r in reqs],
                states=[r.state for r in reqs],
                steps=[r.steps_done for r in reqs],
                latency=[r.latency_us for r in reqs],
                first=[r.first_step_latency_us for r in reqs],
                makespan=makespan, serving=sess.stats()["serving"],
                charges=sess.config_charges())


def sequential(pkg, families, trace, **kw):
    """The request-at-a-time oracle: (outputs by trace order, makespan)."""
    with session(pkg, **kw) as sess:
        models = zoo(pkg, sess, families)
        reqs = [pkg.serve.Request(**t) for t in trace]
        outs, makespan = pkg.serve.serve_sequential(sess, models, reqs)
        return [bits(outs[r.rid]) for r in reqs], makespan


def serve_trace(pkg, families, trace, max_batch=4, **kw):
    with session(pkg, **kw) as sess:
        srv = server(pkg, sess, families, max_batch=max_batch)
        reqs = [pkg.serve.Request(**t) for t in trace]
        for r in reqs:
            assert srv.submit(r)
        makespan = srv.run()
        assert all(r.state == pkg.serve.DONE for r in reqs)
        return served(pkg, sess, reqs, makespan)


# ------------------------------------------------------------ bit identity

def _batched_vs_sequential(pkg, families, n, steps):
    trace = make_trace(pkg, families, n, steps=steps)
    batched = serve_trace(pkg, families, trace)
    oracle, seq_makespan = sequential(pkg, families, trace)
    assert batched["outputs"] == oracle       # BIT identical, not allclose
    return batched, seq_makespan


def test_batched_decode_bit_identical_to_sequential_and_the_reference():
    r, t = both(_batched_vs_sequential, ["transformer", "mamba2", "moe"],
                12, (4, 7))
    assert t == r
    assert t[0]["makespan"] < t[1]           # batching shortens the trace


def test_all_five_families_serve_and_match_the_reference():
    families = sorted(T.serve.PIPELINES)
    assert families == sorted(R.serve.PIPELINES)
    r, t = both(_batched_vs_sequential, families, 10, (3, 4))
    assert t == r


def _stage_fingerprints(pkg):
    """Each family's prefill and decode graphs as captured, and each stage
    kernel's DFG fingerprint: the cache keys the zoo compiles under."""
    out = {}
    with session(pkg, [pkg.Device("a", pkg.spec())]) as sess:
        for fam, spec in sorted(pkg.serve.PIPELINES.items()):
            m = pkg.serve.ServedModel(sess, spec)
            out[fam] = (spec.state_dim, m.prefill_graph.fingerprint(),
                        m.decode_graph.fingerprint(),
                        m.prefill_exec.result().n_partitions,
                        m.decode_exec.result().n_partitions)
            m.release()
    for name, (fn, arity) in sorted(pkg.serve.STAGE_KERNELS.items()):
        out[name] = (arity, pkg.cache.kernel_fingerprint(
            fn, n_inputs=arity, name=name))
    return out


def test_zoo_graphs_and_stage_kernels_fingerprint_as_the_reference():
    r, t = both(_stage_fingerprints)
    assert t == r
    assert set(T.serve.FAMILY_PIPELINE.items()) == \
        set(R.serve.FAMILY_PIPELINE.items())


def _stagepar(pkg):
    with session(pkg) as sess:
        models = zoo(pkg, sess, ["transformer"], max_partition_fus=2)
        model = models["transformer"].result()
        assert model.prefill_exec.n_partitions >= 2   # a real pipeline
        x = np.linspace(-2.0, 2.0, model.state_dim).astype(np.float32)
        whole = sess.launch(model.prefill_exec, x)
        ev, staged = pkg.stagepar.launch_staged(sess, model.prefill_exec, x,
                                                n_micro=4)
        assert isinstance(staged, np.ndarray)
        assert np.array_equal(staged, whole.outputs[0].read())
        assert np.array_equal(ev.outputs[0].read(), staged)
        assert len(ev.deps) == 4
        if pkg.is_port:
            assert ev.outputs[0].data.device.type == "cpu"
        return (model.prefill_exec.n_partitions, bits(staged),
                [(d.kernel_name, d.t_start_us, d.t_end_us)
                 for d in ev.deps], ev.t_end_us, sess.config_charges())


def test_stagepar_microbatched_replay_bit_identical_and_the_reference():
    r, t = both(_stagepar)
    assert t == r


def test_pipeline_schedule_wavefront_equals_the_reference():
    sched = T.pipeline.pipeline_schedule(n_micro=3, n_stages=2)
    assert sched == [(0, 0, 0), (1, 0, 1), (1, 1, 0), (2, 0, 2),
                     (2, 1, 1), (3, 1, 2)]
    for m in range(1, 6):
        for s in range(1, 5):
            assert T.pipeline.pipeline_schedule(m, s) == \
                R.pipeline.pipeline_schedule(m, s)
            assert T.pipeline.bubble_fraction(m, s) == \
                R.pipeline.bubble_fraction(m, s)
    assert T.pipeline.bubble_fraction(3, 2) == pytest.approx(1.0 / 4.0)
    assert T.pipeline.bubble_fraction(8, 1) == 0.0
    for bad in ((0, 1), (1, 0)):
        with pytest.raises(ValueError):
            T.pipeline.pipeline_schedule(*bad)
        with pytest.raises(ValueError):
            T.pipeline.bubble_fraction(*bad)
    assert T.stagepar.pipeline_schedule is T.pipeline.pipeline_schedule


# ------------------------------------------------- iteration-level batching

def _join_and_leave(pkg):
    DONE = pkg.serve.DONE
    seen = []
    with session(pkg) as sess:
        srv = server(pkg, sess, ["transformer"], max_batch=4,
                     iter_quantum=1)
        dim = pkg.serve.PIPELINES["transformer"].state_dim
        early = pkg.serve.Request("transformer", np.ones(dim),
                                  decode_steps=5, t_arrival_us=0.0)
        srv.submit(early)
        batch = srv.batch("transformer")

        def step():
            progressed = srv.step()
            seen.append((progressed, batch.t_us, batch.iterations,
                         len(batch.members), early.steps_done))
            return progressed

        assert step()
        assert batch.members == [early] and early.steps_done == 1
        late = pkg.serve.Request("transformer", np.ones(dim),
                                 decode_steps=2,
                                 t_arrival_us=batch.t_us + 1e9)
        srv.submit(late)
        assert step()
        assert late not in batch.members and late.steps_done == 0
        late.t_arrival_us = 0.0
        assert step()
        assert late in batch.members and late.steps_done == 1
        assert step()
        assert late.state == DONE and late not in batch.members
        assert early in batch.members
        while step():
            pass
        assert early.state == DONE and early.steps_done == 5
        return seen, served(pkg, sess, [early, late])


def test_join_and_leave_at_step_boundaries_as_the_reference():
    r, t = both(_join_and_leave)
    assert t == r


def _capacity(pkg):
    with session(pkg) as sess:
        srv = server(pkg, sess, ["mamba2"], max_batch=2, iter_quantum=1)
        dim = pkg.serve.PIPELINES["mamba2"].state_dim
        reqs = [pkg.serve.Request("mamba2", np.full(dim, float(i)),
                                  decode_steps=3, t_arrival_us=0.0)
                for i in range(5)]
        for r in reqs:
            srv.submit(r)
        batch = srv.batch("mamba2")
        sizes = []
        while srv.step():
            sizes.append(len(batch.members))
        assert max(sizes) <= 2
        return sizes, served(pkg, sess, reqs)


def test_batch_capacity_respected_as_the_reference():
    r, t = both(_capacity)
    assert t == r


# ----------------------------------------------------------- SLO semantics

def _admission(pkg):
    cap = pkg.serve.SLO_CLASSES["realtime"].max_queue
    with session(pkg) as sess:
        srv = server(pkg, sess, {"moe": "realtime"}, max_batch=2)
        dim = pkg.serve.PIPELINES["moe"].state_dim
        reqs = [pkg.serve.Request("moe", np.ones(dim), decode_steps=1,
                                  t_arrival_us=0.0) for _ in range(cap + 4)]
        admitted = [srv.submit(r) for r in reqs]
        assert admitted.count(True) == cap and admitted.count(False) == 4
        assert [r.state for r in reqs[cap:]] == [pkg.serve.REJECTED] * 4
        makespan = srv.run()
        st = sess.stats()["serving"]
        assert st["admitted"] == cap and st["rejected"] == 4
        assert st["completed"] == cap
        assert all(r.output is None for r in reqs[cap:])
        return admitted, served(pkg, sess, reqs[:cap], makespan)


def test_admission_rejects_beyond_slo_queue_cap_as_the_reference():
    r, t = both(_admission)
    assert t == r


def _priority(pkg):
    families = {"transformer": "realtime", "mamba2": "batch"}
    trace = (make_trace(pkg, ["transformer"], 4, seed=1, spread_us=0.0)
             + make_trace(pkg, ["mamba2"], 4, seed=2, spread_us=0.0))
    with session(pkg) as sess:
        srv = server(pkg, sess, families, max_batch=4)
        prio = dict(sess.scheduler.priorities)
        assert prio["transformer"] == pkg.serve.get_slo("realtime").priority
        assert prio["mamba2"] == pkg.serve.get_slo("batch").priority
        reqs = [pkg.serve.Request(**kw) for kw in trace]
        for r in reqs:
            srv.submit(r)
        makespan = srv.run()
        rt_done = max(r.t_done_us for r in reqs[:4])
        batch_done = max(r.t_done_us for r in reqs[4:])
        assert rt_done < batch_done
        lat = sess.stats()["serving"]["latency_us"]
        assert lat["realtime"]["p50"] <= lat["batch"]["p50"]
        return prio, served(pkg, sess, reqs, makespan)


def test_slo_priority_drives_session_and_step_order_as_the_reference():
    r, t = both(_priority)
    assert t == r


def _overrides(pkg):
    raised = []
    with session(pkg) as sess:
        srv = server(pkg, sess, {"moe": "batch"}, max_batch=2)
        dim = pkg.serve.PIPELINES["moe"].state_dim
        req = pkg.serve.Request("moe", np.ones(dim), decode_steps=1,
                                slo="realtime")
        inherit = pkg.serve.Request("moe", np.ones(dim), decode_steps=1)
        for bad, err in ((pkg.serve.Request("nope", np.ones(4),
                                            decode_steps=1), KeyError),
                         (pkg.serve.Request("moe", np.ones(3),
                                            decode_steps=1), ValueError)):
            with pytest.raises(err) as exc:
                srv.submit(bad)
            raised.append((type(exc.value).__name__, str(exc.value)
                           .replace(f"#{bad.rid}", "")
                           .replace(f"request {bad.rid}", "request")))
        return srv.slo_of(req).name, srv.slo_of(inherit).name, raised


def test_request_slo_override_and_unknown_model_as_the_reference():
    r, t = both(_overrides)
    assert t == r
    assert t[:2] == ("realtime", "batch")


# ------------------------------------------------------- warm restart path

def _warm_restart(pkg, root):
    persist = str(root / pkg.root)
    families = ["transformer", "whisper"]
    with session(pkg, persist_dir=persist) as sess:
        models = zoo(pkg, sess, families)
        n_parts = sum(m.prefill_exec.result().n_partitions
                      + m.decode_exec.result().n_partitions
                      for m in models.values())
        cold = sess.cache.stats.as_dict()
        assert cold["misses"] > 0
    with session(pkg, cache=pkg.JITCache(persist_dir=persist)) as sess2:
        models2 = zoo(pkg, sess2, families)
        for m in models2.values():
            m.result()
        assert sess2.cache.stats.misses == 0      # no compiler stage ran
        assert sess2.stats()["disk"]["hits"] >= n_parts
        trace = make_trace(pkg, families, 4, steps=(2, 3))
        reqs = [pkg.serve.Request(**kw) for kw in trace]
        outs, makespan = pkg.serve.serve_sequential(sess2, models2, reqs)
        return (n_parts, cold, sess2.cache.stats.as_dict(),
                sess2.stats()["disk"]["hits"],
                [bits(outs[r.rid]) for r in reqs], makespan)


def test_served_model_warm_restarts_from_disk_tier_as_the_reference(
        tmp_path):
    r, t = both(_warm_restart, tmp_path)
    assert t == r


# ------------------------------------------------------------- chaos legs

def _exec_faults(pkg):
    families = ["transformer", "mamba2"]
    trace = make_trace(pkg, families, 10, seed=3)
    plan = pkg.faults.FaultPlan(seed=11).add("device_exec", rate=0.05)
    with session(pkg, faults=plan) as sess:
        srv = server(pkg, sess, families, max_batch=4)
        reqs = [pkg.serve.Request(**kw) for kw in trace]
        for r in reqs:
            srv.submit(r)
        makespan = srv.run()
        st = sess.stats()
        assert st["serving"]["completed"] == len(reqs)
        chaos = served(pkg, sess, reqs, makespan)
        chaos.update(recovery=st["recovery"], faults=st["faults"])
    oracle, _ = sequential(pkg, families, trace)
    assert chaos["outputs"] == oracle        # healing is bit-transparent
    return chaos


def test_injected_exec_faults_complete_every_request_as_the_reference():
    r, t = both(_exec_faults)
    assert t == r
    assert t["faults"]["injected"].get("device_exec", 0) > 0


def _degraded(pkg):
    families = ["transformer"]
    trace = make_trace(pkg, families, 4, spread_us=0.0, steps=(3, 3))
    plan = pkg.faults.FaultPlan(seed=5).add("device_exec", times=2,
                                            match="ffn_gate")
    retry = pkg.recovery.RetryPolicy(enqueue_retries=0,
                                     breaker_threshold=99)
    with session(pkg, faults=plan, retry=retry) as sess:
        srv = server(pkg, sess, families, max_batch=4)
        reqs = [pkg.serve.Request(**kw) for kw in trace]
        for r in reqs:
            srv.submit(r)
        makespan = srv.run()
        st = sess.stats()
        assert st["serving"]["degraded_steps"] >= 1
        assert st["serving"]["completed"] == len(reqs)
        assert st["recovery"]["fallback_nodewise"] >= 1
        assert st["faults"]["injected"]["device_exec"] == 2
        out = served(pkg, sess, reqs, makespan)
        out.update(recovery=st["recovery"], faults=st["faults"])
    oracle, _ = sequential(pkg, families, trace)
    assert out["outputs"] == oracle
    return out


def test_unhealable_batched_launch_degrades_to_solo_as_the_reference():
    r, t = both(_degraded)
    assert t == r


# ------------------------------------------------------ dashboard + scaling

def _stats_shape(pkg):
    with session(pkg) as sess:
        srv = server(pkg, sess, {"zamba2": "standard"}, max_batch=2)
        dim = pkg.serve.PIPELINES["zamba2"].state_dim
        reqs = [pkg.serve.Request("zamba2", np.full(dim, 0.5),
                                  decode_steps=2, t_arrival_us=0.0)
                for _ in range(4)]
        for r in reqs:
            srv.submit(r)
        makespan = srv.run()
        st = sess.stats()["serving"]
        for key in ("admitted", "completed", "rejected",
                    "degraded_steps", "models", "latency_us"):
            assert key in st
        m = st["models"]["zamba2"]
        assert m["slo"] == "standard"
        assert 0.0 < m["occupancy_ewma"] <= 1.0 and m["iterations"] >= 2
        lat = st["latency_us"]["standard"]
        assert lat["n"] == 4 and lat["p50"] <= lat["p99"]
        return served(pkg, sess, reqs, makespan)


def test_serving_stats_section_shape_as_the_reference():
    r, t = both(_stats_shape)
    assert t == r


def _autoscale(pkg):
    with session(pkg) as sess:
        srv = server(pkg, sess, ["moe"], max_batch=2, iter_quantum=1)
        dim = pkg.serve.PIPELINES["moe"].state_dim
        reqs = [pkg.serve.Request("moe", np.full(dim, 0.1 * i),
                                  decode_steps=6, t_arrival_us=0.0)
                for i in range(6)]
        for r in reqs:
            srv.submit(r)
        for _ in range(4):
            srv.step()
        hints = srv.autoscale_hints()
        assert hints["moe"] == 1
        loads = ops.image_loads
        with ordered_builds(sess):
            caps = srv.apply_autoscale(step=2, ceiling=8)
        assert caps["moe"] == 4 and srv.zoo["moe"].max_replicas == 4
        makespan = srv.run()
        assert all(r.state == pkg.serve.DONE for r in reqs)
        out = served(pkg, sess, reqs, makespan)
        out.update(hints=hints, caps=caps)
        if pkg.is_port:
            # the resized graphs' Programs load their own images: one per
            # partition that served after the resize
            m = srv.zoo["moe"]
            assert ops.image_loads - loads == \
                m.prefill_exec.n_partitions + m.decode_exec.n_partitions
    with session(pkg) as s2:
        models = zoo(pkg, s2, ["moe"])
        outs, _ = pkg.serve.serve_sequential(
            s2, models, [pkg.serve.Request("moe", np.full(dim, 0.1 * i),
                                           decode_steps=6,
                                           t_arrival_us=0.0)
                         for i in range(6)])
    assert out["outputs"] == [bits(o) for o in outs.values()]
    return out


def test_autoscale_hints_and_resize_as_the_reference():
    r, t = both(_autoscale)
    assert t == r


def _lifecycle(pkg):
    Request = pkg.serve.Request
    r = Request("transformer", np.ones(8), decode_steps=2, t_arrival_us=5.0)
    assert r.state == pkg.serve.QUEUED and not r.finished
    assert r.latency_us is None and r.first_step_latency_us is None
    assert r.prompt.dtype == np.float32 and isinstance(r.prompt, np.ndarray)
    errors = []
    for kw in (dict(prompt=np.ones((2, 2)), decode_steps=1),
               dict(prompt=np.ones(8), decode_steps=0),
               dict(prompt=np.ones(8), decode_steps=1, t_arrival_us=-1.0)):
        with pytest.raises(ValueError) as exc:
            Request("transformer", **kw)
        errors.append(str(exc.value).split(":", 1)[1])
    with pytest.raises(KeyError):
        pkg.serve.get_slo("no-such-class")
    classes = {n: (c.priority, c.target_p99_us, c.max_queue)
               for n, c in pkg.serve.SLO_CLASSES.items()}
    for bad in (dict(priority=-1, target_p99_us=1.0, max_queue=1),
                dict(priority=0, target_p99_us=0.0, max_queue=1),
                dict(priority=0, target_p99_us=1.0, max_queue=0)):
        with pytest.raises(ValueError):
            pkg.serve.SLOClass("x", **bad)
    return errors, classes


def test_request_lifecycle_and_validation_as_the_reference():
    r, t = both(_lifecycle)
    assert t == r


# ----------------------------------------------------------- the launcher

def test_overlay_launcher_serves_every_arch_family_as_the_reference(
        capsys):
    from repro.launch.serve import serve_overlay as ref_serve_overlay
    from repro_torch.launch.serve import main, serve_overlay
    kw = dict(n_requests=6, gen=3, slo="realtime", max_batch=4)
    t = serve_overlay("llama3-8b", device="cpu", **kw)
    r = ref_serve_overlay("llama3-8b", **kw)
    assert t["family"] == "transformer"
    assert t["admitted"] == 6 and t["completed"] == 6 and t["rejected"] == 0
    assert t["models"]["transformer"]["slo"] == "realtime"
    assert t["latency_us"]["realtime"]["n"] == 6
    # the launcher's Session keeps its host clock, so its modelled times
    # hold the wall time of its cold builds: compare everything else
    for stats in (t, r):
        stats.pop("makespan_us")
        stats["latency_us"] = {k: v["n"]
                               for k, v in stats["latency_us"].items()}
    assert t == r
    main(["--arch", "llama3-8b", "--device", "cpu", "--requests", "4",
          "--gen", "2"])
    out = capsys.readouterr().out
    assert "pipeline=transformer" in out and "device=cpu" in out
    assert "completed=4" in out


def test_family_map_covers_all_archs_as_the_reference():
    from repro.configs.registry import ALL_ARCHS as R_ARCHS
    from repro.configs.registry import get_arch as r_get_arch
    from repro_torch.configs.registry import ALL_ARCHS, get_arch
    assert sorted(ALL_ARCHS) == sorted(R_ARCHS)
    for arch in ALL_ARCHS:
        fam = T.serve.FAMILY_PIPELINE[get_arch(arch).family]
        assert fam in T.serve.PIPELINES
        assert fam == R.serve.FAMILY_PIPELINE[r_get_arch(arch).family]


def test_overlay_launcher_without_a_card_raises(monkeypatch):
    from repro_torch.launch.serve import serve_overlay
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_overlay("llama3-8b", n_requests=2, gen=1, slo="standard",
                      max_batch=2)


# ------------------------------------------------------- states stay put

def _watch_residency(sess, families, trace, device):
    """Serve ``trace`` stepping by hand; after every step each running
    state is a float32 tensor on ``device``, and no Buffer is read to the
    host (the only reads are the retiring requests' host copies)."""
    srv = server(T, sess, families, max_batch=4)
    reqs = [T.serve.Request(**kw) for kw in trace]
    for r in reqs:
        assert srv.submit(r)
    dev = torch.device(device)
    n_states = 0
    while srv.step():
        for fam in families:
            for state in srv.batch(fam).states:
                assert isinstance(state, torch.Tensor)
                assert state.device.type == dev.type
                assert state.dtype == torch.float32 and state.dim() == 1
                n_states += 1
    assert n_states > 0
    assert all(isinstance(r.output, np.ndarray) for r in reqs)
    return reqs


def test_states_stay_on_the_session_device(monkeypatch):
    families = ["transformer", "whisper"]
    trace = make_trace(T, families, 8, steps=(3, 5))

    def no_read(self):
        raise AssertionError("the serving loop read a Buffer to the host")

    with session(T) as sess:
        monkeypatch.setattr(T.runtime.Buffer, "read", no_read)
        reqs = _watch_residency(sess, families, trace, "cpu")
        monkeypatch.undo()
    oracle, _ = sequential(T, families, trace)
    assert [bits(r.output) for r in reqs] == oracle


# ---------------------------------------------------------- the card legs

@gpu
@pytest.mark.parametrize("families", [["transformer", "mamba2", "moe"],
                                      sorted(T.serve.PIPELINES)])
def test_serving_on_the_card_equals_the_cpu_port(families):
    trace = make_trace(T, families, 12, steps=(3, 6))
    card = serve_trace(T, families, trace, device="cuda")
    host = serve_trace(T, families, trace)
    assert card == host
    oracle, _ = sequential(T, families, trace, device="cuda")
    assert card["outputs"] == oracle


@gpu
def test_states_stay_on_the_card():
    families = ["transformer", "zamba2"]
    trace = make_trace(T, families, 8, steps=(3, 5))
    with session(T, device="cuda") as sess:
        reqs = _watch_residency(sess, families, trace, "cuda")
    oracle, _ = sequential(T, families, trace)
    assert [bits(r.output) for r in reqs] == oracle


@gpu
def test_stagepar_and_degraded_solo_launches_on_the_card():
    with session(T, device="cuda") as sess:
        models = zoo(T, sess, ["transformer"], max_partition_fus=2)
        model = models["transformer"].result()
        x = np.linspace(-2.0, 2.0, model.state_dim).astype(np.float32)
        whole = sess.launch(model.prefill_exec, x)
        ev, staged = T.stagepar.launch_staged(sess, model.prefill_exec, x,
                                              n_micro=4)
        assert ev.outputs[0].data.device.type == "cuda"
        assert np.array_equal(staged, whole.outputs[0].read())
    cpu = _stagepar(T)
    assert bits(staged) == cpu[1]

    plan = T.faults.FaultPlan(seed=5).add("device_exec", times=2,
                                          match="ffn_gate")
    trace = make_trace(T, ["transformer"], 4, spread_us=0.0, steps=(3, 3))
    retry = T.recovery.RetryPolicy(enqueue_retries=0, breaker_threshold=99)
    with session(T, device="cuda", faults=plan, retry=retry) as sess:
        srv = server(T, sess, ["transformer"], max_batch=4)
        reqs = [T.serve.Request(**kw) for kw in trace]
        for r in reqs:
            srv.submit(r)
        srv.run()
        assert sess.stats()["serving"]["degraded_steps"] >= 1
    assert [bits(r.output) for r in reqs] == _degraded(T)["outputs"]
