"""A run with its timed path broken underneath comes out not correct: the
harness's look for a chip skipped, the rest of the run driven at tiny
size on the CPU, once for each fault the cell can have (one chip: no
exchange between chips to leave out; a prefill step keeps no state, but
it can hand back an earlier step's answer)."""

import pytest

from bench.tests import tiny
from repro_torch.models.moe import MoeLM


def _half_batch(logits):
    """The second half of the batch left out, the mean of the rest given."""
    half = logits.shape[0] // 2
    out = logits.clone()
    out[half:] = logits[:half].mean(0, keepdim=True)
    return out


def _altered(logits):
    """The first sequence's answer altered where it is produced: its
    logits negated."""
    out = logits.clone()
    out[0] = -logits[0]
    return out


def _stale():
    """Every step after the first answered with the first one's logits,
    as a cache keyed on the wrong thing would."""
    first = []

    def fault(logits):
        if not first:
            first.append(logits.clone())
        return first[0]
    return fault


FAULTS = {"half_batch": lambda: _half_batch, "altered": lambda: _altered,
          "stale": _stale}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name,cls", [("qwen3-moe.prefill", MoeLM)])
def test_prefill_faults_fail(monkeypatch, name, cls, fault):
    orig, planted = cls.forward_train, FAULTS[fault]()

    def broken(self, *a, **kw):
        return planted(orig(self, *a, **kw))
    monkeypatch.setattr(cls, "forward_train", broken)
    _, out, line = tiny.run(name)
    assert not line["correct"], out.numbers

