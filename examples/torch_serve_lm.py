"""Serve a small model with batched requests through the PyTorch port's
serving launcher — the serving-side end-to-end example, on one CUDA card
unless ``--device cpu``.

It drives ``python -m repro_torch.launch.serve`` the way an operator would:
first the default path (the arch's family mapped onto its overlay serving
pipeline, continuous batching on a Session), then ``--legacy``, the decode
path through the model itself (KV cache, batched greedy sampling, the
flash-attention and RMSNorm kernels on the card).

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""

import argparse

from repro_torch.device import target_device
from repro_torch.launch import serve

ARGS = ["--arch", "qwen3-14b", "--reduced", "--batch", "4",
        "--prompt-len", "12", "--gen", "24"]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where it serves (default: the CUDA card)")
    args = ap.parse_args()
    target_device([], args.device)
    dev = ["--device", args.device] if args.device else []
    for extra in ([], ["--legacy"]):
        argv = ARGS + extra + dev
        print("+ python -m repro_torch.launch.serve " + " ".join(argv),
              flush=True)
        serve.main(argv)


if __name__ == "__main__":
    main()
