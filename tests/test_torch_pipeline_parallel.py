"""The port's pipelined forward (``repro_torch.parallel.pipeline.
make_pipeline_train_step``) against the JAX package's: the body of
``tests/test_pipeline.py`` (4 stages of 2 tanh layers, 8 microbatches) on
4 gloo ranks against the reference's ``shard_map`` on a 4-device host
mesh, from the same numpy inputs; and one stage against the layers
applied one after another."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import make_host_mesh
from repro_torch.parallel.pipeline import make_pipeline_train_step
from torch_dist_pair import jax_running, pipeline_rank, spawn, tanh_layer

N_STAGES, LAYERS_PER_STAGE, N_MICRO, MB, D = 4, 2, 8, 2, 16
TOL = 1e-5
JAX_PIPELINE = """
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.parallel.pipeline import make_pipeline_train_step

inputs, out, n_micro = sys.argv[1], sys.argv[2], int(sys.argv[3])
arrays = np.load(inputs)
w, x = jnp.asarray(arrays["w"]), jnp.asarray(arrays["x"])
mesh = jax.make_mesh((w.shape[0],), ("data",))
step = make_pipeline_train_step(lambda c, lp: jnp.tanh(c @ lp),
                                w.shape[0], n_micro, mesh)
np.save(out, np.asarray(step(w, x)))
"""


def _inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    w = (0.1 * rng.standard_normal(
        (N_STAGES, LAYERS_PER_STAGE, D, D))).astype(np.float32)
    x = rng.standard_normal((N_MICRO, MB, D)).astype(np.float32)
    return w, x


def _sequential(w, x):
    ref = torch.from_numpy(x)
    for lw in torch.from_numpy(w).reshape(-1, D, D):
        ref = torch.tanh(ref @ lw)
    return ref.numpy()


def test_four_stages_match_the_reference_and_the_sequential_stack(tmp_path):
    w, x = _inputs()
    np.savez(tmp_path / "inputs.npz", w=w, x=x)
    with jax_running(JAX_PIPELINE, N_STAGES, str(tmp_path / "inputs.npz"),
                     str(tmp_path / "jax.npy"), str(N_MICRO)):
        spawn(pipeline_rank, N_STAGES, tmp_path,
              str(tmp_path / "inputs.npz"), str(tmp_path / "port_%d.npy"),
              N_MICRO)
    want = np.load(tmp_path / "jax.npy")
    outs = [np.load(tmp_path / f"port_{r}.npy") for r in range(N_STAGES)]
    for got in outs[1:]:                # every rank holds the output
        np.testing.assert_array_equal(got, outs[0])
    np.testing.assert_allclose(outs[0], want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(outs[0], _sequential(w, x), rtol=TOL,
                               atol=TOL)


@pytest.fixture
def one_rank():
    mesh = make_host_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


def test_one_stage_is_the_layers_one_microbatch_after_another(one_rank):
    """One stage: every layer on every microbatch, bit for bit as the
    layers applied to each microbatch in turn, with no send."""
    w, x = _inputs(1)
    w1 = torch.from_numpy(w).reshape(1, -1, D, D)
    run = make_pipeline_train_step(tanh_layer, 1, N_MICRO, one_rank)
    with torch.inference_mode():
        got = run(w1, torch.from_numpy(x))
        for m in range(N_MICRO):
            ref = torch.from_numpy(x[m])
            for lw in w1[0]:
                ref = tanh_layer(ref, lw)
            assert torch.equal(got[m], ref)


def test_the_stage_count_must_be_the_axis_size(one_rank):
    with pytest.raises(ValueError, match="4 stages on a 'data' axis of 1"):
        make_pipeline_train_step(tanh_layer, 4, N_MICRO, one_rank)
