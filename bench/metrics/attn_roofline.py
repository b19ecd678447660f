"""The prefill attention kernel's share of its roofline: the least time of
its calls in the traced steps (4·D operations per visible causal pair per
query head at the bf16 tensor-core rate, or q, k, v and the output once at
the memory rate, whichever is longer) over the device time of the
forward kernel ``flash_attention_wgmma_kernel`` in the trace."""

UNIT, LAYER, MOVES = "%", "kernels", "prefill_tok_s"


def read(rec):
    if rec is None or rec.kind != "prefill" or rec.peak is None \
            or "attn_flops" not in rec.counts:
        return None
    secs, n = rec.kernel_seconds("flash_attention_wgmma_kernel")
    if not n:
        return None
    from bench.counts.peaks import least_seconds
    least = least_seconds(rec.counts["attn_flops"], rec.counts["attn_bytes"],
                          rec.peak) * rec.steps
    return 100.0 * least / secs
