"""The plain references against the port's CPU path at tiny sizes (float32,
where only the order of sums differs), the chunked SSD against its
recurrence, and the controls: the reference in float8 in the program's
place reads far above the program."""

import pytest
import torch

from bench import compare
from bench.reference import mamba2 as ref_mamba
from bench.spec import Spec, load_json
from bench.tests import tiny

# float32 on both sides; the readings at these sizes are about 3e-7
F32_LIMIT = 1e-5


def _dropping(name):
    """The configuration with a capacity factor of 0.5: about half of the
    picks dropped, in the program and in the reference."""
    cfg = Spec().config(Spec().workload(name)["config"])
    assumed = dict(cfg["assumed"], capacity_factor=0.5)
    return {**tiny.OVERRIDES[name]["config"], "assumed": assumed}


CASES = [(n, False) for n in sorted(tiny.OVERRIDES)] + \
    [("qwen3-moe.prefill", True)]


@pytest.mark.parametrize("name,drops", CASES)
def test_program_agrees_with_reference_in_float32(name, drops):
    c = tiny.cell(name)
    if drops:
        c.config = {**c.config, **_dropping(name)}
    out = tiny.harness.run_cell(c)
    line = tiny.harness.result(c, out)
    assert line["correct"]
    for key, value in out.numbers.items():
        assert value < F32_LIMIT, (key, value)


@pytest.mark.parametrize("control", ["fp8", "fp8_attn"])
@pytest.mark.parametrize("name", sorted(tiny.OVERRIDES))
def test_float8_control_reads_far_above_the_program(name, control):
    """Every product in float8, or attention's two alone."""
    _, out, _ = tiny.run(name, control=control)
    key = "logit_rel_err"
    assert out.control[key] > 1e3 * max(out.numbers[key], 1e-7)


def _mamba2(seed=tiny.SEED):
    """The Mamba2 configuration at tiny size, its family module and the
    weights drawn from ``seed`` on the CPU in float32."""
    cfg = {**load_json(Spec().bench / "configs" / "mamba2-370m.json"),
           **tiny.SSM}
    fam = Spec().module("families", "ssm")
    W = fam.weights(cfg, seed, "cpu", torch.float32, 256)
    return cfg, fam, W


@pytest.mark.parametrize("batch,seq", [(2, 32), (1, 64)])
def test_mamba2_reference_is_the_port_prefill(batch, seq):
    """The port's prefill step (float32, its plain routes on the CPU) and
    the reference's on the same weights and tokens: the last logits."""
    from repro_torch.train.step import make_prefill_step
    cfg, fam, W = _mamba2()
    model = fam.build(cfg, torch.float32)
    toks = torch.randint(0, cfg["vocab_size"], (batch, seq),
                         generator=torch.Generator().manual_seed(seq))
    got = make_prefill_step(model)(fam.params(W), {"tokens": toks})
    want = ref_mamba.prefill_last_logits(W, cfg, toks)
    v = cfg["vocab_size"]
    assert compare.rel(got[:, :v], want[:, :v]) < F32_LIMIT


def test_mamba2_family_refuses_what_the_port_lacks():
    cfg, fam, _ = _mamba2()
    for key in ("conv_bias", "residual_in_fp32"):
        with pytest.raises(ValueError):
            fam.arch({**cfg, key: True}, torch.float32)


@pytest.mark.parametrize("seq", [24, 40])
def test_chunked_ssd_is_the_recurrence(seq):
    cfg, _, W = _mamba2()
    toks = torch.randint(0, cfg["vocab_size"], (2, seq),
                         generator=torch.Generator().manual_seed(5))
    state = ref_mamba.init_state(cfg, 2, "cpu")
    for t in range(toks.shape[1]):
        step, state = ref_mamba.decode_step(W, cfg, toks[:, t], state)
    whole = ref_mamba.prefill_last_logits(W, cfg, toks)
    assert compare.rel(step, whole) < 1e-5


def test_state_carries_across_chunks():
    """The published init's slow decays keep a state across chunks: the
    last logits move when only the first chunk's tokens change."""
    cfg, _, W = _mamba2()
    toks = torch.randint(0, cfg["vocab_size"], (1, 32),
                         generator=torch.Generator().manual_seed(6))
    other = toks.clone()
    other[:, :8] = (other[:, :8] + 1) % cfg["vocab_size"]
    a = ref_mamba.prefill_last_logits(W, cfg, toks)
    b = ref_mamba.prefill_last_logits(W, cfg, other)
    assert compare.rel(a, b) > 1e-4
