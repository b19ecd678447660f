"""Fault-tolerance scenario on the PyTorch port: train → simulated node
failure → elastic restart on a smaller cluster plan, resuming from the
validated checkpoint, on one CUDA card unless ``--device cpu``.

This is the paper's resource-aware replication at cluster scale: the
runtime exposes fewer resources after the failure, and the planner picks a
new coherent (dp × tp) mesh without touching model code — exactly like the
overlay compiler picking a smaller replication factor when 'other logic'
eats fabric (paper Fig. 5).  The restored state is placed on the new mesh
by its sharding specs (``launch/mesh.py::place``).

    PYTHONPATH=src python examples/torch_elastic_restart.py [--device cpu]

It plans over the ranks of the process group; where none exists it starts
one of one rank, and ends it on its way out.
"""

import argparse
import tempfile

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs.registry import get_arch, reduced_config
from repro_torch.core.replicate import plan_cluster
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.device import target_device
from repro_torch.launch.mesh import make_host_mesh, place
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import TrainLoop, TrainLoopConfig
from repro_torch.train.step import init_state, make_train_step, state_specs


def _mesh_for(plan, dev) -> DeviceMesh:
    return DeviceMesh(dev.type, torch.arange(
        plan.dp_replicas * plan.model_shards).reshape(plan.mesh_shape),
        mesh_dim_names=("data", "model"))


def run(dev) -> None:
    cfg = reduced_config(get_arch("llama3-8b"))
    model = build_model(cfg, remat_policy="none")
    opt = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=60)
    ds = SyntheticTokens(cfg.vocab, seq=32, batch=4)
    step = make_train_step(model, opt)

    with tempfile.TemporaryDirectory() as ckdir:
        # phase 1: "healthy cluster" — plan for all ranks of the world
        mesh0 = make_host_mesh(1, device=dev)
        n0 = dist.get_world_size()
        plan0 = plan_cluster(n0, model_shards=1)
        print(f"phase 1: {n0} ranks on {dev} → mesh {plan0.mesh_shape}")
        state = init_state(model, torch.Generator(device=dev).manual_seed(0),
                           mesh=mesh0)
        loop = TrainLoop(step, state, ds,
                         TrainLoopConfig(total_steps=30, checkpoint_every=10,
                                         checkpoint_dir=ckdir, log_every=10))
        loop.run()
        print("  checkpointed through step 30; "
              "'node failure' now removes ranks")

        # phase 2: a "failure" leaves fewer ranks — replan and resume.  On
        # one rank the failure is modelled by replanning for n-1 ranks;
        # the elastic planner benches the stragglers and rebuilds the mesh.
        plan1 = plan_cluster(max(1, n0 - 1), model_shards=1)
        print(f"phase 2: {max(1, n0 - 1)} ranks → mesh {plan1.mesh_shape} "
              f"(dropped {plan1.dropped_devices})")
        mesh1 = _mesh_for(plan1, dev)
        fresh = init_state(model, torch.Generator(device=dev).manual_seed(1),
                           mesh=mesh1)
        loop2 = TrainLoop(step, fresh, ds,
                          TrainLoopConfig(total_steps=60,
                                          checkpoint_every=10,
                                          checkpoint_dir=ckdir,
                                          log_every=10))
        assert loop2.try_restore(), "must resume from phase-1 checkpoint"
        # the restored state is placed on the NEW mesh by its specs
        loop2.state = place(loop2.state, state_specs(model), mesh1)
        print(f"  resumed at step {loop2.start_step} on the new mesh")
        out = loop2.run()
        losses = [m["loss"] for m in out["metrics"]]
        print(f"  continued to step {out['final_step']}; "
              f"loss {losses[0]:.3f} → {losses[-1]:.3f}")
        assert loop2.start_step == 30 and out["final_step"] == 60
        print("elastic restart OK")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where it trains (default: the CUDA card)")
    args = ap.parse_args()
    dev = target_device([], args.device)
    started = not dist.is_initialized()
    try:
        run(dev)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
