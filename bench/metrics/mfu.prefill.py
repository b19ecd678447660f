"""The prefill step's share of the chip's peak: the step's least time at
the data sheet's peaks (operations at the bf16 tensor-core rate, bytes at
the memory rate, :mod:`bench.counts`) over its measured time, the traced
steps' host-clock window divided among them."""

UNIT, LAYER, MOVES = "%", "model step", "prefill_tok_s"


def read(rec):
    if rec is None or rec.kind != "prefill" or rec.peak is None:
        return None
    from bench.counts.peaks import least_seconds
    least = least_seconds(rec.counts["flops"], rec.counts["bytes"], rec.peak)
    return 100.0 * least / (rec.window_s / rec.steps)
