"""Tiny sizes of the benchmark's cells, for the CPU tests: every family
path at a few hundred parameters, in float32 (the program's plain
routes on the CPU), windows of a fraction of a second."""

import time

from bench import harness
from bench.spec import Spec

MOE = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
       "head_dim": 16, "num_experts": 4, "num_experts_per_tok": 2,
       "moe_intermediate_size": 32, "vocab_size": 256,
       "num_hidden_layers": 2, "torch_dtype": "float32",
       # logits of about the full size's spread (0.02 · √4096 = 0.16 · √64)
       "initializer_range": 0.16}
SSM = {"d_model": 64, "d_state": 16, "headdim": 16, "chunk_size": 8,
       "vocab_size": 250, "n_layer": 2, "torch_dtype": "float32"}
# the cells of BENCHMARK.json at tiny size; SSM sizes the Mamba2
# reference's tests (mamba2-370m has no cell yet)
OVERRIDES = {
    "qwen3-moe.prefill": {"config": MOE, "traffic": {"batch": 2, "seq": 32}},
}
SEED = 2 ** 31 + 987654321


def cell(name, spec=None, trace=False, seconds=0.3, **kw):
    """The cell ``name`` at its tiny size on the CPU."""
    return harness.make_cell(spec or Spec(), name, SEED, seconds, trace,
                             "cpu", time.perf_counter(),
                             OVERRIDES[name], **kw)


def run(name, **kw):
    """→ (cell, outcome, result line)."""
    c = cell(name, **kw)
    out = harness.run_cell(c)
    return c, out, harness.result(c, out)
