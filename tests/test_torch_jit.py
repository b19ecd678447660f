"""The port's JIT compiler and execution paths against the JAX package.

For the paper's six kernels on two overlay sizes, ``repro_torch``'s
``jit_compile`` must produce the same artifacts as ``repro``'s: DFG,
replication plan, P&R strategy, placement, routing, latency, bitstream and
program.  ``run_overlay`` and compiled mode must give ``run_reference``'s
float32 bits (tolerance: bit-exact, since every op is one separately
rounded float32 operation on both sides; NaN positions must agree where
NaNs arise).  CPU tensors take the plain PyTorch paths; the ``gpu`` tests
run the CUDA executor on a card.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.configs.paper_suite import BENCHMARKS as R_BENCHMARKS
from repro.core.jit import jit_compile as r_jit_compile
from repro.core.jit import overlay_jit as r_overlay_jit
from repro.core.overlay import OverlaySpec as ROverlaySpec
from repro_torch import device as device_mod
from repro_torch.configs.paper_suite import BENCHMARKS
from repro_torch.core import dfg as dfg_mod
from repro_torch.core.jit import jit_compile, lower_to_dfg, overlay_jit
from repro_torch.core.options import CompileOptions
from repro_torch.core.overlay import OverlaySpec
from repro_torch.core.program import program_from_arrays
from repro_torch.kernels.overlay_exec import kernel, ops

pytestmark = pytest.mark.filterwarnings("ignore::RuntimeWarning")

SPECS = [(8, 8, 2), (32, 8, 2)]
NAMES = sorted(BENCHMARKS)
N_ITEMS = 301


def gpu(fn):
    """Needs a CUDA card: decided when the test runs, not at import."""
    fn = pytest.mark.skipif("not torch.cuda.is_available()",
                            reason="needs a CUDA card")(fn)
    return pytest.mark.gpu(fn)


def assert_same_bits(got, want):
    got = np.asarray(torch.as_tensor(got).cpu(), np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    nan_g, nan_w = np.isnan(got), np.isnan(want)
    np.testing.assert_array_equal(nan_g, nan_w)
    np.testing.assert_array_equal(got.view(np.int32)[~nan_g],
                                  want.view(np.int32)[~nan_w])


@functools.lru_cache(maxsize=None)
def _compiled(name, spec):
    src = BENCHMARKS[name][0]
    return jit_compile(src, OverlaySpec(*spec)), \
        r_jit_compile(src, ROverlaySpec(*spec))


def _inputs(ck, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, N_ITEMS).astype(np.float32)
            for _ in ck.dfg.inputs]


def _dfg_fields(g):
    return (g.name, g.inputs, g.outputs, g.optimized,
            [(n.nid, n.op, n.args, n.imm, n.name) for n in g.nodes.values()])


def _fields(obj):
    return dataclasses.astuple(obj)


def test_paper_suite_copy_matches_reference():
    assert sorted(BENCHMARKS) == sorted(R_BENCHMARKS)
    for name, (src, replicas, oracle) in BENCHMARKS.items():
        r_src, r_replicas, r_oracle = R_BENCHMARKS[name]
        assert (src, replicas) == (r_src, r_replicas)
        xs = [np.linspace(-1, 1, 17, dtype=np.float32)
              for _ in range(oracle.__code__.co_argcount)]
        np.testing.assert_array_equal(oracle(*xs), r_oracle(*xs))


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("name", NAMES)
def test_compile_artifacts_match_reference(name, spec):
    ck, rk = _compiled(name, spec)
    assert _dfg_fields(ck.dfg) == _dfg_fields(rk.dfg)
    assert ck.fug.n_fus == rk.fug.n_fus and ck.fug.edges == rk.fug.edges
    assert [_fields(s) for s in ck.fug.supers] == \
        [_fields(s) for s in rk.fug.supers]
    assert _fields(ck.plan) == _fields(rk.plan)
    assert ck.plan.replicas >= 1
    assert ck.pr_path == rk.pr_path
    assert _fields(ck.placement) == _fields(rk.placement)
    assert [_fields(n) for n in ck.routing.nets] == \
        [_fields(n) for n in rk.routing.nets]
    assert (ck.routing.iterations, ck.routing.max_channel_load,
            ck.routing.total_wirelength) == \
        (rk.routing.iterations, rk.routing.max_channel_load,
         rk.routing.total_wirelength)
    assert _fields(ck.latency) == _fields(rk.latency)
    assert ck.bitstream.sha256() == rk.bitstream.sha256()
    p, rp = ck.program, rk.program
    np.testing.assert_array_equal(p.instrs, rp.instrs)
    np.testing.assert_array_equal(p.imms, rp.imms)
    assert (p.name, p.n_regs, p.in_slots, p.out_slots) == \
        (rp.name, rp.n_regs, rp.in_slots, rp.out_slots)
    assert p.content_hash() == rp.content_hash()
    assert set(ck.stage_times_ms) == set(rk.stage_times_ms)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("name", NAMES)
def test_cpu_execution_matches_run_reference(name, spec):
    ck, rk = _compiled(name, spec)
    xs = _inputs(ck)
    want = rk.run_reference(*xs)
    np.testing.assert_allclose(want, BENCHMARKS[name][2](*xs), rtol=1e-4,
                               atol=1e-5)
    assert_same_bits(ck.run_reference(*xs), want)
    got = ck.run_overlay(*xs, device="cpu")
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert_same_bits(got, want)
    ts = [torch.from_numpy(x) for x in xs]
    assert_same_bits(ck.run_overlay(*ts), want)
    assert_same_bits(ck(*ts), want)
    # the reference's own compiled program, carried over as plain fields
    rp = rk.program
    prog = program_from_arrays(rp.name, rp.n_regs, rp.instrs, rp.imms,
                               rp.in_slots, rp.out_slots)
    assert_same_bits(ops.execute(prog, xs, device="cpu")[0], want)


KERNELS = {
    "gelu_poly": (lambda x: x * (x * (x * 0.044715 + 1.0)), 1),
    "minmax": (lambda a, b: a.max(0.0) * b.min(2.0) + a.min(b), 2),
    "multi_out": (lambda a, b: (a + b, a * b - 1.5, 3.0 - a), 2),
}


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_traced_kernel_matches_reference(name):
    fn, n = KERNELS[name]
    ck = overlay_jit(fn, n, OverlaySpec(8, 8, 2), name=name)
    rk = r_overlay_jit(fn, n, ROverlaySpec(8, 8, 2), name=name)
    assert _dfg_fields(ck.dfg) == _dfg_fields(rk.dfg)
    np.testing.assert_array_equal(ck.program.instrs, rk.program.instrs)
    assert ck.plan.replicas == rk.plan.replicas
    rng = np.random.default_rng(5)
    specials = np.array([np.nan, 0.0, -0.0, np.inf, -np.inf, 1e-40],
                        np.float32)
    xs = [np.concatenate([rng.permutation(specials),
                          rng.standard_normal(60).astype(np.float32)])
          for _ in range(n)]
    want = rk.run_reference(*xs)
    want = want if isinstance(want, tuple) else (want,)
    ts = [torch.from_numpy(x) for x in xs]
    for got in (ck.run_overlay(*ts), ck(*ts)):
        got = got if isinstance(got, tuple) else (got,)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same_bits(g, w)


@pytest.mark.parametrize("a, b", [
    (torch.tensor([np.nan, 1.0, 0.0, -0.0]), 0.5),
    (0.5, torch.tensor([np.nan, 1.0, 0.0, -0.0])),
    (torch.tensor([np.nan, 1.0, 0.0, -0.0]),
     torch.tensor([1.0, np.nan, -0.0, 0.0])),
])
def test_dfg_min_max_on_tensors_follow_numpy(a, b):
    na = a.numpy() if isinstance(a, torch.Tensor) else np.float32(a)
    nb = b.numpy() if isinstance(b, torch.Tensor) else np.float32(b)
    assert_same_bits(dfg_mod._generic_min(a, b), np.minimum(na, nb))
    assert_same_bits(dfg_mod._generic_max(a, b), np.maximum(na, nb))


def test_dfg_min_max_keep_numpy_and_scalars():
    assert dfg_mod._generic_min(2.0, 3) == 2.0
    assert dfg_mod._generic_max(2.0, 3) == 3
    out = dfg_mod._generic_min(np.array([1.0, 5.0], np.float32), 2.0)
    assert isinstance(out, np.ndarray) and out.tolist() == [1.0, 2.0]


def test_lower_to_dfg_matches_reference():
    src = BENCHMARKS["qspline"][0]
    from repro.core.jit import lower_to_dfg as r_lower_to_dfg
    assert _dfg_fields(lower_to_dfg(src, parse_source=True)) == \
        _dfg_fields(r_lower_to_dfg(src, parse_source=True))
    assert lower_to_dfg(src) == src


def test_cache_and_verifier_are_not_silently_ignored():
    from repro_torch.core.cache import JITCache
    src = BENCHMARKS["poly1"][0]
    cache = JITCache()
    first = jit_compile(src, OverlaySpec(8, 8, 2), cache=cache)
    assert jit_compile(src, OverlaySpec(8, 8, 2), cache=cache) is first
    assert (cache.stats.hits, cache.stats.misses) == (1, 1)
    for level in ("fused", "full"):
        with pytest.raises(NotImplementedError, match="analysis slice"):
            jit_compile(src, OverlaySpec(8, 8, 2),
                        opts=CompileOptions(verify_level=level))


def test_deprecated_knobs_warn_and_build_the_same():
    src = BENCHMARKS["poly1"][0]
    with pytest.warns(DeprecationWarning):
        old = jit_compile(src, OverlaySpec(8, 8, 2), max_replicas=4)
    new = jit_compile(src, OverlaySpec(8, 8, 2),
                      opts=CompileOptions(max_replicas=4))
    assert old.plan.replicas == new.plan.replicas == 4
    assert old.bitstream.sha256() == new.bitstream.sha256()


def test_entry_points_raise_without_a_card(monkeypatch):
    """No device given, no tensor to follow and no card: the call raises and
    names the way out; it never falls back to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ck, _ = _compiled("poly1", SPECS[0])
    x = np.linspace(-1, 1, 8, dtype=np.float32)
    for call in (lambda: ck.run_overlay(x), lambda: ck(x),
                 lambda: ops.execute(ck.program, [x]),
                 device_mod.default_device):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    assert ck.run_overlay(x, device="cpu").device.type == "cpu"


def test_inputs_on_another_device_are_an_error():
    ck, _ = _compiled("sgfilter", SPECS[0])
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="input tensor on"):
        ck.run_overlay(x, x.to("meta"))
    with pytest.raises(ValueError, match="input tensor on"):
        ck.run_overlay(x, x, device="meta")


def test_compiled_mode_keeps_tensor_dtype():
    ck, _ = _compiled("poly1", SPECS[0])
    x = torch.linspace(-1, 1, 16, dtype=torch.float64)
    assert ck(x).dtype == torch.float64
    assert ck(x.numpy(), device="cpu").dtype == torch.float32


# ---------------------------------------------------------------- on a card
@gpu
@pytest.mark.parametrize("name", NAMES)
def test_cuda_run_overlay_matches_run_reference(name):
    ck, rk = _compiled(name, SPECS[0])
    xs = _inputs(ck, seed=7)
    want = rk.run_reference(*xs)
    before = kernel.overlay_execute.launches
    got = ck.run_overlay(*xs)                       # numpy → the card
    assert kernel.overlay_execute.launches == before + 1
    assert got.is_cuda
    assert_same_bits(got, want)
    assert_same_bits(ck(*[torch.from_numpy(x).cuda() for x in xs]), want)
