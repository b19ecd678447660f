"""The RMSNorm forward kernel's share of its roofline in prefill: the
bytes of every norm of the traced steps (x read, y written, the weight
once a call) at the memory rate, over the device time of the kernels
``rmsnorm_rows`` and ``rmsnorm_loop`` in the trace."""

UNIT, LAYER, MOVES = "%", "kernels", "prefill_tok_s"


def read(rec):
    if rec is None or rec.kind != "prefill" or rec.peak is None:
        return None
    secs, n = rec.kernel_seconds("rmsnorm_rows", "rmsnorm_loop")
    if not n:
        return None
    least = rec.counts["rmsnorm_bytes"] * rec.steps / rec.peak["bytes_s"]
    return 100.0 * least / secs
