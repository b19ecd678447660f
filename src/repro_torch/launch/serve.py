"""The serving entry point of the port.

``--legacy`` drives the raw-torch serving loop: random prompts from a
numpy seed, token-recurrent prefill through ``make_serve_step``, then
greedy (argmax) decoding, or categorical sampling from a seeded
``torch.Generator`` when ``--temperature`` > 0.  On one card:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \
      --legacy --batch 4 --prompt-len 128 --gen 32

(``--reduced`` for the tiny smoke config, ``--device cpu`` for the CPU.)

The default path of the JAX package serves through the overlay Session
(``serve_overlay``); the port has no Session yet, so it raises
``NotImplementedError`` until the runtime slice of ``ROADMAP.md`` brings
one.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.registry import ALL_ARCHS, get_arch, reduced_config
from repro_torch.device import target_device
from repro_torch.models.registry import build_model
from repro_torch.train.step import make_serve_step

# picks the next tokens (B,) from next-token logits (B, V) at decode step i
Picker = Callable[[torch.Tensor, int], torch.Tensor]


def greedy(logits: torch.Tensor, step: int) -> torch.Tensor:
    return logits.argmax(dim=-1)


def sampler(temperature: float, gen: torch.Generator) -> Picker:
    """Categorical sampling at ``temperature`` from ``gen`` (on the logits'
    device)."""
    def pick(logits: torch.Tensor, step: int) -> torch.Tensor:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]
    return pick


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor      # (B, gen) the generated tokens
    logits: torch.Tensor      # (prompt_len + gen, B, V) after each step
    prefill_s: float          # host clock, ends in a device synchronise
    decode_s: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def serve_loop(model, params, prompt, gen: int,
               pick: Picker = greedy) -> ServeResult:
    """Serve ``prompt`` (B, P) token ids on the device of ``params``:
    feed the prompt one token at a time through ``serve_step`` (its KV
    cache holds P + gen positions), then ``gen`` tokens, each picked by
    ``pick`` from the last logits and fed back.  As in the JAX loop, the
    step after the last generated token runs too, so ``logits`` holds
    P + gen rows."""
    device = params["lm"]["embed"].device
    prompt = torch.as_tensor(np.asarray(prompt), device=device)
    b, plen = prompt.shape
    cache = model.init_cache(b, plen + gen, device=device)
    serve_step = make_serve_step(model)
    logits_seen = []

    _sync(device)
    t0 = time.perf_counter()
    logits = None
    for i in range(plen):
        logits, cache = serve_step(params, cache, prompt[:, i:i + 1], i)
        logits_seen.append(logits)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    out_tokens = []
    t0 = time.perf_counter()
    for i in range(gen):
        nxt = pick(logits, i)[:, None].to(prompt.dtype)
        out_tokens.append(nxt)
        logits, cache = serve_step(params, cache, nxt, plen + i)
        logits_seen.append(logits)
    _sync(device)
    t_gen = time.perf_counter() - t0
    tokens = (torch.cat(out_tokens, dim=1) if out_tokens
              else prompt.new_zeros((b, 0)))
    return ServeResult(tokens, torch.stack(logits_seen), t_prefill, t_gen)


def _legacy_main(args) -> ServeResult:
    """The raw-torch serving loop, random weights from seed 0."""
    device = target_device([], args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab, (args.batch, args.prompt_len), np.int32)
    pick = greedy if args.temperature <= 0 else sampler(
        args.temperature, torch.Generator(device=device).manual_seed(0))
    res = serve_loop(model, params, prompt, args.gen, pick)
    print(f"arch={args.arch} batch={args.batch} device={device} "
          f"prefill {args.prompt_len} tok in {res.prefill_s:.2f}s | "
          f"decode {args.gen} tok in {res.decode_s:.2f}s "
          f"({args.batch * args.gen / res.decode_s:.1f} tok/s)")
    print("sample:", res.tokens[0, :16].tolist())
    return res


def serve_overlay(*_args, **_kwargs) -> dict:
    """Serving through the overlay Session (the JAX package's default
    path): not ported yet."""
    raise NotImplementedError(
        "serving through the overlay Session needs the port's Session, "
        "which comes with the runtime slice of ROADMAP.md; use --legacy "
        "for the raw-torch loop")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ALL_ARCHS), required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--legacy", action="store_true",
                    help="the raw-torch loop (the only path ported yet)")
    ap.add_argument("--device", default=None,
                    help="where the loop runs (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.legacy:
        _legacy_main(args)
        return
    serve_overlay(args.arch)


if __name__ == "__main__":
    main()
