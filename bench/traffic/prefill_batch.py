"""Prefill traffic: a closed loop of prefill steps through the program's
``make_prefill_step``.  Step i takes B prompts of S token ids drawn from
the seed (the draw named ("tokens", i)), and its last position's logits
are read back to the host: the read-back closes the step.

``prefill_tok_s``: the prompt tokens of every step started in the
window, over the time from the window's start to the last one's read-back.

The check: the steps of a sample drawn from the seed, the last one in it,
through the family's float32 reference on the same tokens and weights;
the numbers are taken over all their rows (:func:`bench.compare.logits`).

Mix keys: batch, seq, check_steps, trace_steps."""

from __future__ import annotations

import torch
from torch.profiler import record_function

from bench import compare, draw
from bench.harness import Cell, Outcome, chip_peaks, now
from bench.trace import Records, Tracer

def run(cell: Cell) -> Outcome:
    fam, cfg, mix, dev = cell.family, cell.config, cell.mix, cell.device
    t_entry = now()
    from repro_torch.train.step import make_prefill_step
    b, s = mix["batch"], mix["seq"]
    vocab = cfg["vocab_size"]
    model = fam.build(cfg, cell.dtype)
    W = fam.weights(cfg, cell.seed, dev, cell.dtype, model.cfg.vocab_padded)
    params = fam.params(W)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_weights = now()
    step = make_prefill_step(model)
    gen = torch.Generator(device=dev)

    def tokens(i: int) -> torch.Tensor:
        gen.manual_seed(draw.sub_seed(cell.seed, "tokens", i))
        return draw.tokens(gen, (b, s), vocab)

    step(params, {"tokens": tokens(-1)})[:, :vocab].to("cpu")   # warm-up
    t_setup = now()
    setup_s = t_setup - cell.t0

    tracer = Tracer(dev, cell.trace_path()) if cell.trace else None
    n_trace = mix["trace_steps"]
    outputs, ends = [], []
    t_start = now()
    deadline = t_start + cell.seconds
    while now() < deadline or (tracer and len(ends) < 1 + n_trace):
        if tracer and len(ends) == 1:
            tracer.start()
        with record_function("bench.step"):
            out = step(params, {"tokens": tokens(len(ends))})
        with record_function("bench.readback"):
            outputs.append(out[:, :vocab].to("cpu"))
        ends.append(now())
        if tracer and len(ends) == 1 + n_trace:
            tracer.stop()
    rate = b * s * len(ends) / (ends[-1] - t_start)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    records = None
    if tracer:
        dv, host = tracer.events()
        records = Records(kind="prefill", device=dv, host=host,
                          window_s=tracer.t1 - tracer.t0, steps=n_trace,
                          counts=cell.counts.prefill(cfg, b, s),
                          peak=chip_peaks(dev))
    del out
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    rows, low_rows = {}, {}
    ref = fam.REFERENCE
    for i in compare.sample_steps(list(range(len(ends))),
                                  mix["check_steps"], cell.seed):
        toks = tokens(i)
        want = ref.prefill_last_logits(W, cfg, toks, "f32")[:, :vocab]
        compare.join(rows, compare.rows(outputs[i], want))
        if cell.control:
            low = ref.prefill_last_logits(W, cfg, toks, cell.control)
            compare.join(low_rows, compare.rows(low[:, :vocab], want))
    numbers = compare.logits(rows)
    control = compare.logits(low_rows) if low_rows else {}
    return Outcome(e2e={"prefill_tok_s": rate}, setup_s=setup_s,
                   attempted=b * len(ends), failed=0, numbers=numbers,
                   control=control, memory_peak=peak, records=records,
                   notes=[f"setup {setup_s:.3f} s: start and imports "
                          f"{t_entry - cell.t0:.3f}, program and weights "
                          f"{t_weights - t_entry:.3f}, warm-up step "
                          f"{t_setup - t_weights:.3f}",
                          f"steps {len(ends)} in {ends[-1] - t_start:.3f} s",
                          "rows logit_rel_err "
                          + " ".join(f"{v:.5f}" for v in rows["rel"])])

