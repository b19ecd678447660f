"""The share of the traced window of prefill steps in which no operation
runs on the device: one less the union of the device operations'
intervals over the window."""

UNIT, LAYER, MOVES = "%", "device", "prefill_tok_s"
KIND = "prefill"


def read(rec):
    if rec is None or rec.kind != KIND or not rec.device:
        return None
    return 100.0 * (1.0 - rec.busy_s() / rec.window_s)
