"""End-to-end driver of the PyTorch port: train a ~100M-param llama-family
model for a few hundred steps through the port's training path (the
flash-attention and RMSNorm kernels forward and backward on the card,
AdamW, checkpointing, restart, the straggler watchdog, overlay-JIT'd
activations), on one CUDA card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300]
"""

import argparse
import dataclasses
import tempfile

import torch

from repro_torch.configs.registry import get_arch
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.device import target_device
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import TrainLoop, TrainLoopConfig
from repro_torch.train.step import init_state, make_train_step


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="where it trains (default: the CUDA card)")
    args = ap.parse_args()
    dev = target_device([], args.device)

    # ~100M llama-family config
    cfg = dataclasses.replace(
        get_arch("llama3-8b"), n_layers=6, d_model=512, n_heads=8,
        n_kv_heads=4, d_ff=1536, vocab=8192, head_dim=64)
    model = build_model(cfg, remat_policy="none")
    print(f"params: {cfg.param_count():,} on {dev}")

    state = init_state(model, torch.Generator(device=dev).manual_seed(0))
    step_fn = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=20,
                                                 total_steps=args.steps))

    with tempfile.TemporaryDirectory() as ckdir:
        loop = TrainLoop(step_fn, state,
                         SyntheticTokens(cfg.vocab, args.seq, args.batch),
                         TrainLoopConfig(total_steps=args.steps,
                                         checkpoint_dir=ckdir,
                                         checkpoint_every=100,
                                         log_every=25))
        out = loop.run()
        losses = [m["loss"] for m in out["metrics"]]
        for m in out["metrics"]:
            print(f"step {m['step']:4d}  loss {m['loss']:.4f}  "
                  f"{m['dt_s'] * 1e3:6.0f} ms")
        print(f"loss: {losses[0]:.3f} → {losses[-1]:.3f} "
              f"({'improved' if losses[-1] < losses[0] else 'FLAT'})")
        assert losses[-1] < losses[0], "training did not reduce loss"

        # restart-from-checkpoint proof
        state2 = init_state(model, torch.Generator(device=dev).manual_seed(0))
        loop2 = TrainLoop(step_fn, state2,
                          SyntheticTokens(cfg.vocab, args.seq, args.batch),
                          TrainLoopConfig(total_steps=args.steps + 10,
                                          checkpoint_dir=ckdir))
        assert loop2.try_restore(), "restore failed"
        print(f"restart: resumed from step {loop2.start_step} OK")


if __name__ == "__main__":
    main()
