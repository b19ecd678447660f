"""Which ring exchange a gloo group can carry between ranks that share one
CUDA card: 4 spawned ranks pass a float32 and a bfloat16 tensor on the
card to their successor around the ring by ``batch_isend_irecv``, by
``send``/``recv``, and by an ``all_to_all_single`` whose only nonzero
splits are the pair's (the exchange ``repro_torch.parallel.pipeline``
uses).  Each way runs in ranks of its own; a way whose ranks abort is
reported with how they ended.

    python3 benchmarks/torch_gloo_exchange.py [--device cpu]
"""

import argparse
import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WAYS = ("batch_isend_irecv", "send_recv", "all_to_all_single")
N = 4
TIMEOUT_S = 120


def _exchange(way: str, t: torch.Tensor, r: int, n: int) -> torch.Tensor:
    nxt, prv = (r + 1) % n, (r - 1) % n
    got = torch.empty_like(t)
    if way == "batch_isend_irecv":
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, t, nxt),
                                           dist.P2POp(dist.irecv, got, prv)]):
            req.wait()
    elif way == "send_recv":
        if r % 2 == 0:
            dist.send(t, nxt)
            dist.recv(got, prv)
        else:
            dist.recv(got, prv)
            dist.send(t, nxt)
    else:
        sends, recvs = [0] * n, [0] * n
        sends[nxt] = recvs[prv] = t.numel()
        dist.all_to_all_single(got.view(-1), t.view(-1), recvs, sends)
    return got


def _rank(r: int, n: int, store: str, way: str, device: str) -> None:
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, n), rank=r,
                            world_size=n)
    try:
        for dtype in (torch.float32, torch.bfloat16):
            t = torch.full((3, 1000), float(r), device=device, dtype=dtype)
            got = _exchange(way, t, r, n)
            if device == "cuda":
                torch.cuda.synchronize()
            if not bool((got == (r - 1) % n).all()):
                raise RuntimeError(f"rank {r} {way} {dtype}: wrong values")
    finally:
        dist.destroy_process_group()


def run(way: str, device: str) -> str:
    """"ok", or how the ranks of ``way`` ended."""
    store = os.path.join(tempfile.mkdtemp(), "store")
    ctx = mp.spawn(_rank, args=(N, store, way, device), nprocs=N,
                   join=False)
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                return f"no end within {TIMEOUT_S} s"
    except mp.ProcessRaisedException as e:
        return f"raised: {str(e).strip().splitlines()[-1]}"
    except mp.ProcessExitedException as e:
        return f"a rank ended: {e}"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return "ok"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_gloo_exchange: no CUDA device; pass --device cpu to "
              "rehearse on the CPU", file=sys.stderr)
        return 2
    where = torch.cuda.get_device_name(0) if args.device == "cuda" \
        else "cpu"
    for way in WAYS:
        print(f"{way} on {N} gloo ranks, {args.device} tensors ({where}): "
              f"{run(way, args.device)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
