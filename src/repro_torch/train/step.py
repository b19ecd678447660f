"""prefill_step / serve_step builders: the units the serving launcher
drives.  Both run under ``torch.inference_mode()``.

The training step (``make_train_step``, ``init_state``) waits for the
training slice of ``ROADMAP.md``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch


def make_prefill_step(model) -> Callable:
    """Forward-only full-sequence step (inference prefill): returns logits
    of the last position (next-token), (B, V)."""

    @torch.inference_mode()
    def prefill_step(params, batch: Dict[str, Any]) -> torch.Tensor:
        # last_only: the (B, S, V) logits tensor is never materialised —
        # only the final position is unembedded
        logits = model.forward_train(params, batch["tokens"],
                                     batch.get("input_embeds"),
                                     last_only=True)
        return logits[:, -1]

    return prefill_step


def make_serve_step(model) -> Callable:
    """(params, cache, tokens, cur_pos) → (next_logits (B, V), cache); the
    cache is updated in place."""

    @torch.inference_mode()
    def serve_step(params, cache, tokens: torch.Tensor, cur_pos: int):
        logits, cache = model.forward_decode(params, cache, tokens, cur_pos)
        return logits[:, -1], cache

    return serve_step
