"""The port's roofline arithmetic (``repro_torch.launch.roofline``) against
the JAX package's (``repro.launch.roofline``).

The analytic counts are the reference's own numbers, exactly, for every
architecture, shape and remat policy.  ``Roofline`` gives the reference's
dictionary for the same counts once the reference's rates are patched into
the port's module, and the H100's data-sheet rates otherwise.  The
collective term weighs the dry run's records (kind, dtype, local shape)
by the reference's ring factors: the same bytes as the reference reads
from HLO text of the same collectives.  ``analyze`` keeps the reference's
floor, ``max(counted, analytic / devices)``.  Every comparison is exact:
both packages do the same float arithmetic in the same order.
"""

import math

import pytest
import torch
from repro.configs.registry import ALL_ARCHS as REF_ARCHS
from repro.configs.registry import SHAPES as REF_SHAPES
from repro.launch import roofline as ref_rl

from repro_torch.configs.registry import ALL_ARCHS, SHAPES
from repro_torch.launch import roofline as rl

REMATS = ("full", "dots", "none")
# H100 SXM5 data sheet (repro_torch/launch/mesh.py)
H100 = dict(PEAK_FLOPS_BF16=989e12, HBM_BW=3.35e12, ICI_BW=450e9)


@pytest.mark.parametrize("arch", sorted(ALL_ARCHS))
def test_analytic_counts_equal_the_reference(arch):
    assert SHAPES == REF_SHAPES
    cfg, ref_cfg = ALL_ARCHS[arch], REF_ARCHS[arch]
    for seq, batch, kind in SHAPES.values():
        assert rl.model_flops(cfg, seq, batch, kind) == \
            ref_rl.model_flops(ref_cfg, seq, batch, kind)
        assert rl.attention_flops(cfg, seq, batch, kind) == \
            ref_rl.attention_flops(ref_cfg, seq, batch, kind)
        for remat in REMATS:
            assert rl.analytic_hlo_flops(cfg, seq, batch, kind, remat) == \
                ref_rl.analytic_hlo_flops(ref_cfg, seq, batch, kind, remat)


# (flops, bytes, collective bytes) a device: one of each dominant term
# at the H100's rates
COUNTS = {"compute": (4.2e14, 2.0e11, 1.0e10),
          "memory": (1.0e12, 7.5e12, 1.0e10),
          "collective": (1.0e12, 1.0e11, 9.0e11)}


def _pair(counts):
    f, b, c = counts
    kw = dict(flops_per_device=f, bytes_per_device=b,
              coll_bytes_per_device=c,
              coll_breakdown={"all-reduce": c * 0.75, "all-gather": c * 0.25},
              model_flops_global=f * 200.0, n_devices=256)
    return rl.Roofline(**kw), ref_rl.Roofline(**kw)


@pytest.mark.parametrize("which", sorted(COUNTS))
def test_roofline_dict_equals_the_reference_at_its_rates(monkeypatch, which):
    for name in H100:
        monkeypatch.setattr(rl, name, getattr(ref_rl, name))
    port, ref = _pair(COUNTS[which])
    assert port.to_dict() == ref.to_dict()


@pytest.mark.parametrize("which", sorted(COUNTS))
def test_roofline_in_the_h100_rates(which):
    for name, value in H100.items():
        assert getattr(rl, name) == value
    port, ref = _pair(COUNTS[which])
    d = port.to_dict()
    f, b, c = COUNTS[which]
    assert d["compute_s"] == f / 989e12
    assert d["memory_s"] == b / 3.35e12
    assert d["collective_s"] == c / 450e9
    assert d["dominant"] == which
    assert d["step_s"] == max(f / 989e12, b / 3.35e12, c / 450e9)
    assert d["mfu"] == d["model_flops_global"] / (256 * 989e12 * d["step_s"])
    assert sorted(d) == sorted(ref.to_dict())
    # never the TPU's rates
    assert d["compute_s"] != ref.to_dict()["compute_s"]


# one collective of each kind: (record, the HLO line the JAX package reads)
COLLECTIVES = [
    (("all-reduce", torch.bfloat16, (16, 4096, 640)),
     "%ar = bf16[16,4096,640]{2,1,0} all-reduce(%x), replica_groups={}"),
    (("all-gather", torch.bfloat16, (16, 4096, 128)),
     "%ag = bf16[16,4096,128]{2,1,0} all-gather(%x), dimensions={2}"),
    (("reduce-scatter", torch.float32, (320, 5120)),
     "%rs = f32[320,5120]{1,0} reduce-scatter(%g), dimensions={0}"),
    (("all-to-all", torch.bfloat16, (8, 128, 1536)),
     "%a2a = bf16[8,128,1536]{2,1,0} all-to-all(%t), dimensions={0}"),
    (("collective-permute", torch.float32, (2, 64, 4096)),
     "%cp = f32[2,64,4096]{2,1,0} collective-permute(%h), pairs={{0,1}}"),
    (("all-reduce-start", torch.bfloat16, (5120,)),
     "%ars = bf16[5120]{0} all-reduce-start(%n), replica_groups={}"),
]


@pytest.mark.parametrize("i", range(len(COLLECTIVES)))
def test_collective_bytes_weigh_records_by_the_ring_factors(i):
    record, line = COLLECTIVES[i]
    kind, dtype, shape = record
    want = math.prod(shape) * dtype.itemsize * ref_rl._COLL_FACTOR[kind]
    assert rl._COLL_FACTOR == ref_rl._COLL_FACTOR
    assert rl.collective_bytes([record]) == {kind: want}
    # the reference's HLO parse of the same op ("-start" folds into its
    # kind there; the factor is the same)
    ref = ref_rl.collective_bytes(line)
    assert sum(ref.values()) == want


def test_collective_bytes_sum_by_kind():
    records = [r for r, _ in COLLECTIVES] + [COLLECTIVES[0][0]]
    text = "\n".join(line for _, line in COLLECTIVES)
    port = rl.collective_bytes(records)
    one = math.prod((16, 4096, 640)) * 2 * 2.0
    assert port["all-reduce"] == 2 * one
    assert sum(port.values()) == \
        sum(ref_rl.collective_bytes(text).values()) + one


class _Compiled:
    """What the reference's ``analyze`` reads of a compiled object."""

    def __init__(self, flops, byts, text):
        self.cost = {"flops": flops, "bytes accessed": byts}
        self.text = text

    def cost_analysis(self):
        return self.cost

    def as_text(self):
        return self.text


@pytest.mark.parametrize("counted", ["below_the_floor", "above_the_floor"])
def test_analyze_keeps_the_reference_floor(monkeypatch, counted):
    for name in H100:
        monkeypatch.setattr(rl, name, getattr(ref_rl, name))
    arch, (seq, batch, kind) = "qwen3-14b", SHAPES["train_4k"]
    floor = ref_rl.analytic_hlo_flops(REF_ARCHS[arch], seq, batch, kind,
                                      "full") / 256
    flops = floor * (0.5 if counted == "below_the_floor" else 1.5)
    records = [r for r, _ in COLLECTIVES[:3]]
    text = "\n".join(line for _, line in COLLECTIVES[:3])
    port = rl.analyze(rl.Counts(flops, 3.0e12, records), ALL_ARCHS[arch],
                      seq, batch, kind, 256)
    ref = ref_rl.analyze(_Compiled(flops, 3.0e12, text), REF_ARCHS[arch],
                         seq, batch, kind, 256)
    assert port.to_dict() == ref.to_dict()
    assert port.flops_per_device == max(flops, floor)

