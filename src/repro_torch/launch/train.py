"""End-to-end training driver: ``repro/launch/train.py``'s command line,
on the CUDA card of each rank.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
      --reduced --steps 200 --batch 8 --seq 128 --ckpt /tmp/ckpt

drives the train step (AdamW, ``--remat`` checkpointing of each layer
body, the flash-attention and RMSNorm kernels forward and backward),
checkpoint/restart and the straggler watchdog through ``TrainLoop``.
Without ``--reduced`` the architecture runs at full size: at full width
only a cut of the deepest models fits one card (see ``chip_smoke.py``).

The mesh is ``make_host_mesh(--model-shards)`` over the world's ranks
(one rank: a (1, 1) mesh, as the reference's on one device; 8 ranks with
``--model-shards 4``: (data=2, model=4)) or ``--production-mesh`` (which
needs 256 ranks).  The parameters are placed on it by ``param_specs``
(the ranks drawing in turns), the optimizer's state beside them, and each
batch by ``input_shardings``: on a mesh axis above 1 every leaf is a
DTensor (tensor and expert parallelism on 'model', data parallelism on
'data'), every family included (a Mamba2 block whose widths 'model'
does not divide raises, naming the width).  Rank 0 alone
prints and writes the checkpoints.  Where no process group exists, the
driver starts one of one rank and ends it on its way out.  The CPU is for
the tests: ``main(argv, device="cpu")`` on every rank.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.registry import ALL_ARCHS, get_arch, reduced_config
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.device import DeviceLike, target_device
from repro_torch.launch.mesh import (check_widths, make_host_mesh,
                                     make_production_mesh, mesh_device)
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import TrainLoop, TrainLoopConfig
from repro_torch.train.step import init_state, make_train_step


def main(argv=None, device: DeviceLike = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ALL_ARCHS), required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--model-shards", type=int, default=1)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--metrics-out", default=None)
    args = ap.parse_args(argv)
    # segments that grow in place: a step's changing temporaries otherwise
    # strand gigabytes of the card in fragments (read before CUDA's first
    # allocation, so only a fresh process takes it)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    dev = target_device([], device)
    started = not dist.is_initialized()
    try:
        return _run(args, dev)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _run(args, dev: torch.device) -> Dict[str, Any]:
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    model = build_model(cfg, remat_policy=args.remat)
    mesh = (make_production_mesh(device=dev) if args.production_mesh
            else make_host_mesh(args.model_shards, dev))
    check_widths(cfg, mesh)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(1, args.steps // 10),
                          total_steps=args.steps)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = init_state(model, gen, mesh=mesh)
    step_fn = make_train_step(model, opt_cfg)
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)

    ds = SyntheticTokens(cfg.vocab, args.seq, args.batch)
    extra: Dict[str, Any] = {}
    if cfg.frontend == "vision":
        extra["input_embeds"] = np.zeros(
            (args.batch, max(1, args.seq // 8), cfg.d_model), np.float32)
    if cfg.frontend == "audio":
        extra["input_embeds"] = np.zeros(
            (args.batch, args.seq, cfg.d_model), np.float32)

        class AudioDS(SyntheticTokens):
            def batch_at(self, step):
                b = super().batch_at(step)
                n = max(8, args.seq // 4)
                return {"tokens": b["tokens"][:, :n],
                        "labels": b["labels"][:, :n]}
        ds = AudioDS(cfg.vocab, args.seq, args.batch)

    loop = TrainLoop(step_fn, state, ds,
                     TrainLoopConfig(total_steps=args.steps,
                                     checkpoint_dir=args.ckpt,
                                     checkpoint_every=max(10,
                                                          args.steps // 4)),
                     extra_batch=extra or None)
    resumed = loop.try_restore()
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    say(f"arch={args.arch} reduced={args.reduced} mesh={shape} "
        f"device={mesh_device(mesh)} params={cfg.param_count():,} "
        f"resumed={resumed} start={loop.start_step}")
    out = loop.run()
    for m in out["metrics"]:
        say(f"  step {m['step']:5d} loss {m['loss']:.4f} "
            f"gnorm {m['grad_norm']:.3f} {m['dt_s']*1e3:.0f}ms")
    if out["stragglers"]:
        say(f"  straggler events: {len(out['stragglers'])}")
    if args.metrics_out and dist.get_rank() == 0:
        with open(args.metrics_out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
