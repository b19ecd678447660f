"""The reduction from a trace to the per-layer metrics, on records made by
hand: the busy union, the breakdown and each reader's arithmetic."""

import pytest

from bench.counts.peaks import peaks
from bench.spec import Spec
from bench.trace import Records

H100 = peaks("NVIDIA H100 80GB HBM3")


def _records(kind, **kw):
    device = [("flash_attention_wgmma_kernel<128>", 0.0, 0.2),
              ("rmsnorm_rows<bf16>", 0.1, 0.2),       # overlaps the first
              ("gemm", 0.5, 0.3)]
    host = [("bench.step", 0.0, 1.0), ("aten::copy_", 0.25, 0.5)]
    base = dict(kind=kind, device=device, host=host, window_s=1.0, steps=2,
                counts={"flops": 989e12 * 0.1, "bytes": 0.0,
                        "attn_flops": 989e12 * 0.05, "attn_bytes": 0.0,
                        "rmsnorm_bytes": 3.35e12 * 0.02},
                peak=H100)
    base.update(kw)
    return Records(**base)


def test_busy_union_and_breakdown():
    rec = _records("prefill")
    assert rec.busy_intervals() == [(0.0, 0.30000000000000004), (0.5, 0.8)]
    assert rec.busy_s() == pytest.approx(0.6)
    b = rec.breakdown()
    assert b["device_ops"][0] == ["gemm", 0.3]
    gap = b["idle_gaps"][0]
    assert gap[0] == "aten::copy_" and gap[1] == pytest.approx(0.2)


def _read(name, rec):
    return Spec().module("metrics", name).read(rec)


def test_readers_by_hand():
    rec = _records("prefill")
    # least 0.1 s a step, 0.5 s a traced step
    assert _read("mfu.prefill", rec) == pytest.approx(20.0)
    assert _read("idle_share.prefill", rec) == pytest.approx(40.0)
    # two steps' 0.05 s at the peak against 0.2 s of the kernel
    assert _read("attn_roofline", rec) == pytest.approx(50.0)
    assert _read("rmsnorm_roofline", rec) == pytest.approx(20.0)
    for name in ("mfu.prefill", "idle_share.prefill", "attn_roofline",
                 "rmsnorm_roofline"):
        assert _read(name, _records("decode")) is None   # another kind's


def test_no_kernels_or_no_peak_reads_nothing():
    assert _read("attn_roofline", _records("prefill", device=[])) is None
    assert _read("mfu.prefill", _records("prefill", peak=None)) is None
    assert _read("rmsnorm_roofline", _records("prefill", device=[])) is None
