"""The serving entry point of the port.

The default path drives :mod:`repro_torch.serve`: the requested arch's
family is mapped onto its overlay serving pipeline
(:data:`repro_torch.serve.models.FAMILY_PIPELINE`), an
:class:`~repro_torch.serve.server.InferenceServer` is stood up on a
modelled two-device Session whose launches run the overlay executor on
the CUDA card, and a synthetic request trace is served with continuous
batching — printing admission/completion counters, batch occupancy and
per-SLO-class modelled latency from ``Session.stats()["serving"]``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --requests 24 --gen 8

(``--device cpu`` runs the executor's plain version on the CPU.)

``--legacy`` drives the raw-torch serving loop: random prompts from a
numpy seed, token-recurrent prefill through ``make_serve_step``, then
greedy (argmax) decoding, or categorical sampling from a seeded
``torch.Generator`` when ``--temperature`` > 0.  On one card:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \
      --legacy --batch 4 --prompt-len 128 --gen 32

(``--reduced`` for the tiny smoke config, ``--device cpu`` for the CPU.)
The parameters and the cache are placed by ``param_specs`` and
``cache_specs`` on ``make_host_mesh(--model-shards)``, as the reference
places them: on one rank a (1, 1) mesh; a process group of one rank is
started, and ended on the way out, where none exists.  On several ranks
(``--model-shards 4`` on 4) every leaf is a DTensor: the heads, the ff
width and the vocabulary on 'model', the cache's key/value heads there
where they divide it, else its sequence; greedy picking reads the
vocab-sharded logits, and rank 0 alone prints.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.registry import ALL_ARCHS, get_arch, reduced_config
from repro_torch.device import DeviceLike, target_device
from repro_torch.launch.mesh import (axis_size, check_family, make_host_mesh,
                                     place, place_in_turns)
from repro_torch.models import common as dt
from repro_torch.models.registry import build_model
from repro_torch.train.step import inference, make_serve_step

# picks the next tokens (B,) from next-token logits (B, V) at decode step i
Picker = Callable[[torch.Tensor, int], torch.Tensor]


def greedy(logits: torch.Tensor, step: int) -> torch.Tensor:
    """The first id of the largest logit.  On vocab-sharded logits each
    rank takes its shard's, and the (value, id) pairs are gathered over
    the shards (B values each, never the logits)."""
    if not isinstance(logits, DTensor):
        return logits.argmax(dim=-1)
    mesh, dims = logits.device_mesh, dt.mesh_dims(logits, -1)
    lf = logits.to_local().float()
    idx = lf.argmax(-1)
    pair = torch.stack([lf.gather(-1, idx[:, None])[:, 0],
                        (idx + dt.offset(logits, -1)).float()])[None]
    pl = dt.with_placement(dt.replicated(mesh), dims, Shard(0))
    both = dt.gather(dt.from_local(pair, mesh, pl), 0).to_local()
    best = both[:, 0].argmax(0)              # the first shard holding it
    tok = both[:, 1].gather(0, best[None])[0].long()
    out = dt.with_placement(logits.placements, dims, Replicate())
    return dt.from_local(tok, mesh, out)


def sampler(temperature: float, gen: torch.Generator) -> Picker:
    """Categorical sampling at ``temperature`` from ``gen`` (on the logits'
    device); sharded logits are gathered whole first, every rank drawing
    the same ids from its own ``gen`` of the same seed."""
    def pick(logits: torch.Tensor, step: int) -> torch.Tensor:
        probs = torch.softmax(dt.full(logits).float() / temperature, dim=-1)
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


def serve_loop(model, params, prompt, gen: int, pick: Picker = greedy,
               place_cache: Optional[Callable] = None) -> ServeResult:
    with inference(params):
        return _serve_loop(model, params, prompt, gen, pick, place_cache)


def _serve_loop(model, params, prompt, gen: int, pick: Picker,
                place_cache: Optional[Callable]) -> ServeResult:
    """Serve ``prompt`` (B, P) token ids on the device of ``params``:
    feed the prompt one token at a time through ``serve_step`` (its KV
    cache holds P + gen positions), then ``gen`` tokens, each picked by
    ``pick`` from the last logits and fed back.  As in the JAX loop, the
    step after the last generated token runs too, so ``logits`` holds
    P + gen rows (gathered whole where they are DTensors, after the timed
    loops).  ``place_cache``, if given, places the new cache (the legacy
    driver's, by ``cache_specs``)."""
    device = params["lm"]["embed"].device
    prompt = torch.as_tensor(np.asarray(prompt), device=device)
    b, plen = prompt.shape
    cache = model.init_cache(b, plen + gen, device=device)
    if place_cache is not None:
        cache = place_cache(cache)
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
    tokens = (torch.cat([dt.full(t) for t in out_tokens], dim=1)
              if out_tokens else prompt.new_zeros((b, 0)))
    return ServeResult(tokens, torch.stack([dt.full(t) for t in logits_seen]),
                       t_prefill, t_gen)


def _legacy_main(args) -> ServeResult:
    """The raw-torch serving loop, random weights from seed 0, placed on
    the host mesh of ``args.model_shards`` (default 1)."""
    device = target_device([], args.device)
    started = not dist.is_initialized()
    try:
        return _legacy_run(args, device)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _legacy_run(args, device: torch.device) -> ServeResult:
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    model = build_model(cfg)
    mesh = make_host_mesh(getattr(args, "model_shards", 1), device)
    check_family(cfg.family, mesh)
    params = place_in_turns(
        lambda: model.init(torch.Generator(device=device).manual_seed(0)),
        model.param_specs(), mesh)
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab, (args.batch, args.prompt_len), np.int32)
    pick = greedy if args.temperature <= 0 else sampler(
        args.temperature, torch.Generator(device=device).manual_seed(0))
    cache_specs = model.cache_specs(model_axis=axis_size(mesh, "model"))
    res = serve_loop(model, params, prompt, args.gen, pick,
                     lambda c: place(c, cache_specs, mesh))
    if dist.get_rank() == 0:
        print(f"arch={args.arch} batch={args.batch} device={device} "
              f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))} "
              f"prefill {args.prompt_len} tok in {res.prefill_s:.2f}s | "
              f"decode {args.gen} tok in {res.decode_s:.2f}s "
              f"({args.batch * args.gen / res.decode_s:.1f} tok/s)")
        print("sample:", res.tokens[0, :16].tolist())
    return res


def serve_overlay(arch: str, n_requests: int, gen: int, slo: str,
                  max_batch: int, devices: int = 2, seed: int = 0,
                  device: DeviceLike = None) -> dict:
    """Serve a synthetic trace for ``arch`` through repro_torch.serve;
    returns the ``stats()["serving"]`` blob (drives both main() and the
    parity test).  ``device`` is where the Session's launches run (default:
    the CUDA card)."""
    from repro_torch.core.runtime import Device, OverlaySpec
    from repro_torch.core.session import Session
    from repro_torch.serve import InferenceServer, Request
    from repro_torch.serve.models import FAMILY_PIPELINE, PIPELINES

    cfg = get_arch(arch)
    family = FAMILY_PIPELINE[cfg.family]
    dim = PIPELINES[family].state_dim
    spec = OverlaySpec(width=8, height=8, dsp_per_fu=2)
    rng = np.random.default_rng(seed)
    with Session([Device(f"ovl{i}", spec) for i in range(devices)],
                 device=device) as s:
        srv = InferenceServer(s, {family: slo}, max_batch=max_batch)
        reqs = [Request(family, rng.standard_normal(dim), decode_steps=gen,
                        t_arrival_us=float(i) * 25.0)
                for i in range(n_requests)]
        for r in reqs:
            srv.submit(r)
        makespan = srv.run()
        stats = s.stats()["serving"]
        stats["makespan_us"] = makespan
        stats["family"] = family
        srv.close()
    return stats


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ALL_ARCHS), required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4,
                    help="legacy: batch size; default: max batch")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--model-shards", type=int, default=1,
                    help="legacy: the host mesh's model axis")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--legacy", action="store_true",
                    help="the raw-torch loop (bypasses the Session)")
    ap.add_argument("--requests", type=int, default=16,
                    help="overlay path: synthetic trace length")
    ap.add_argument("--slo", choices=("realtime", "standard", "batch"),
                    default="standard")
    ap.add_argument("--device", default=None,
                    help="where the loop runs (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.legacy:
        _legacy_main(args)
        return

    stats = serve_overlay(args.arch, args.requests, args.gen, args.slo,
                          max_batch=args.batch, device=args.device)
    fam = stats["family"]
    m = stats["models"][fam]
    print(f"arch={args.arch} -> pipeline={fam} slo={args.slo} "
          f"max_batch={args.batch} "
          f"device={target_device([], args.device)}")
    print(f"admitted={stats['admitted']} completed={stats['completed']} "
          f"rejected={stats['rejected']} "
          f"degraded_steps={stats['degraded_steps']}")
    print(f"iterations={m['iterations']} "
          f"occupancy_ewma={m['occupancy_ewma']:.2f} "
          f"makespan={stats['makespan_us']:.0f}us")
    for cls, lat in stats["latency_us"].items():
        print(f"  {cls}: n={lat['n']} p50={lat['p50']:.0f}us "
              f"p99={lat['p99']:.0f}us")


if __name__ == "__main__":
    main()
