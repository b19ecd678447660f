"""The port's pipelined step (``repro_torch.parallel.pipeline.
make_pipeline_train_step``) against the JAX package's: the body of
``tests/test_pipeline.py`` (4 stages of 2 tanh layers, 8 microbatches) on
4 gloo ranks against the reference's ``shard_map`` on a 4-device host
mesh, from the same numpy inputs; its backward against ``jax.grad`` of the
reference's step (tanh layers, the bubble, 2 stages, and the reduced
qwen3-14b's layers); and one stage against the layers applied one after
another."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import make_host_mesh
from repro_torch.parallel.pipeline import make_pipeline_train_step
from torch_dist_pair import (PIPE_ARCH, PIPE_LAYERS, jax_running,
                             pipeline_grad_rank, pipeline_rank, spawn,
                             tanh_layer, wait_for)

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


# the gradients: tanh layers at weight scale 0.3 (gradients of order 1),
# each rank's block and x's gradient within GRAD_TOL of the reference's
# largest value; the reduced qwen3-14b's within QWEN_GRAD_TOL
GRAD_SCALE, GRAD_TOL, QWEN_GRAD_TOL = 0.3, 1e-5, 1e-4
QWEN_MICRO, QWEN_MB, QWEN_S = 4, 2, 8
JAX_PIPELINE_GRAD = """
import dataclasses, os, sys
import numpy as np, jax, jax.numpy as jnp
from repro.parallel.pipeline import make_pipeline_train_step

inputs, out, n_micro, kind = sys.argv[1], sys.argv[2], int(sys.argv[3]), \\
    sys.argv[4]
n = jax.device_count()
arrays = np.load(inputs)
x, c = jnp.asarray(arrays["x"]), jnp.asarray(arrays["c"])
if kind == "tanh":
    w = {"w": jnp.asarray(arrays["w"])}

    def layer_fn(h, lp):
        return jnp.tanh(h @ lp["w"])
else:
    from repro.configs.registry import ALL_ARCHS, reduced_config
    from repro.models.registry import build_model
    cfg = dataclasses.replace(reduced_config(ALL_ARCHS[sys.argv[5]]),
                              dtype=jnp.float32, n_layers=int(sys.argv[6]))
    model = build_model(cfg, remat_policy="none")
    layers = jax.jit(model.init)(jax.random.PRNGKey(0))["layers"]
    flat = {"/".join(k.key for k in path): np.asarray(a) for path, a in
            jax.tree_util.tree_flatten_with_path(layers)[0]}
    np.savez(inputs + ".part.npz", **flat)
    os.replace(inputs + ".part.npz", inputs + ".layers.npz")
    pos = jnp.arange(x.shape[2])

    def layer_fn(h, lp):
        return model._layer_train(h, lp, pos)
    w = jax.tree.map(lambda a: a.reshape((n, -1) + a.shape[1:]), layers)
mesh = jax.make_mesh((n,), ("data",))
step = make_pipeline_train_step(layer_fn, n, n_micro, mesh)
# under JAX 0.9.0 differentiating the shard_map step needs the mesh set:
# without it jax.grad raises "Length of device assignment 1 is not equal
# to the size of the mesh" (the forward alone runs either way)
with jax.set_mesh(mesh):
    y = step(w, x)
    gw, gx = jax.grad(lambda w, x: jnp.sum(step(w, x) * c),
                      argnums=(0, 1))(w, x)
flat = {"g/" + "/".join(k.key for k in path): np.asarray(a) for path, a in
        jax.tree_util.tree_flatten_with_path(gw)[0]}
np.savez(out, y=np.asarray(y), gx=np.asarray(gx), **flat)
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


def _rel(got, want) -> float:
    """The largest difference over the largest |want|."""
    return float(np.abs(got - want).max() / np.abs(want).max())


def _hold_grads(tmp_path, n_stages, n_micro, kind, tol, *child_args):
    """The port's step and backward on ``n_stages`` gloo ranks against
    ``jax.grad`` of the reference's on as many host devices, from
    ``tmp_path``'s inputs: the output, every rank's x gradient and each
    rank's block gradient within ``tol`` of the reference's largest value."""
    inputs = tmp_path / "inputs.npz"
    with jax_running(JAX_PIPELINE_GRAD, n_stages, str(inputs),
                     str(tmp_path / "jax.npz"), str(n_micro), kind,
                     *child_args, timeout=600) as proc:
        if kind != "tanh":
            wait_for(tmp_path / "inputs.npz.layers.npz", proc)
        spawn(pipeline_grad_rank, n_stages, tmp_path, str(inputs),
              str(tmp_path / "port_%d.npz"), n_micro, kind, timeout=600)
    want = np.load(tmp_path / "jax.npz")
    wkeys = sorted(k for k in want.files if k.startswith("g/"))
    errs = {}
    for r in range(n_stages):
        got = np.load(tmp_path / f"port_{r}.npz")
        assert sorted(k for k in got.files if k.startswith("g/")) == wkeys
        errs[f"rank {r} y"] = _rel(got["y"], want["y"])
        errs[f"rank {r} x"] = _rel(got["gx"], want["gx"])
        for k in wkeys:
            assert got[k].shape == (1,) + want[k].shape[1:]
            errs[f"rank {r} {k}"] = _rel(got[k][0], want[k][r])
    worst = max(errs, key=errs.get)
    print(f"{kind}, {n_stages} stages, {n_micro} microbatches: largest "
          f"relative difference {errs[worst]:.3g} ({worst})")
    assert errs[worst] <= tol, (worst, errs[worst])


@pytest.mark.parametrize("n_stages,n_micro", [(4, 8), (4, 2), (2, 8)],
                         ids=["4_stages", "bubble_2_micro", "2_stages"])
def test_gradients_match_jax_grad_of_the_reference_step(tmp_path, n_stages,
                                                        n_micro):
    """tanh layers, 2 a stage: every rank's block gradient and x's
    gradient as ``jax.grad`` of the reference's step gives them, the
    bubble (2 microbatches on 4 stages) and 2 stages included."""
    rng = np.random.default_rng(3)
    np.savez(tmp_path / "inputs.npz",
             w=(GRAD_SCALE * rng.standard_normal(
                 (n_stages, LAYERS_PER_STAGE, D, D))).astype(np.float32),
             x=rng.standard_normal((n_micro, MB, D)).astype(np.float32),
             c=rng.standard_normal((n_micro, MB, D)).astype(np.float32))
    _hold_grads(tmp_path, n_stages, n_micro, "tanh", GRAD_TOL)


@pytest.mark.parametrize("n_stages", [2, 4])
def test_qwen3_layer_gradients_match_jax_grad(tmp_path, n_stages):
    """The reduced qwen3-14b in float32, 4 layers over the stages, with
    ``DenseLM._layer_train`` as the layer and the reference's parameters
    carried across by ``params_from_numpy``."""
    rng = np.random.default_rng(4)
    d = 64      # the reduced config's width
    shape = (QWEN_MICRO, QWEN_MB, QWEN_S, d)
    np.savez(tmp_path / "inputs.npz",
             x=rng.standard_normal(shape).astype(np.float32),
             c=rng.standard_normal(shape).astype(np.float32))
    _hold_grads(tmp_path, n_stages, QWEN_MICRO, "qwen3", QWEN_GRAD_TOL,
                PIPE_ARCH, str(PIPE_LAYERS))


def test_one_stage_gradients_are_the_sequential_layers(one_rank):
    """One stage on one rank: the output with grad bit for bit the output
    without, and the gradients of the block and of x those of autograd
    through the layers applied to each microbatch in turn."""
    w, x = _inputs(2)
    w1 = torch.from_numpy(w).reshape(1, -1, D, D) * 3
    c = torch.from_numpy(np.random.default_rng(5).standard_normal(
        x.shape).astype(np.float32))
    run = make_pipeline_train_step(tanh_layer, 1, N_MICRO, one_rank)
    wp = w1.clone().requires_grad_()
    xp = torch.from_numpy(x).requires_grad_()
    y = run(wp, xp)
    with torch.no_grad():
        assert torch.equal(y, run(w1, torch.from_numpy(x)))
    (y * c).sum().backward()
    ws = w1.clone().requires_grad_()
    xs = torch.from_numpy(x).requires_grad_()
    h = xs
    for lw in ws[0]:
        h = tanh_layer(h, lw)
    (h * c).sum().backward()
    assert torch.equal(y, h)
    torch.testing.assert_close(wp.grad, ws.grad, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(xp.grad, xs.grad, rtol=1e-6, atol=1e-6)


def test_a_forward_without_grad_saves_no_graph(one_rank):
    """Under ``inference_mode`` or ``no_grad`` the step records nothing,
    though its inputs require grad; with grad it keeps every step's."""
    w, x = _inputs(1)
    w1 = torch.from_numpy(w).reshape(1, -1, D, D).requires_grad_()
    x1 = torch.from_numpy(x).requires_grad_()
    seen = []

    def layer(h, lw):
        out = tanh_layer(h, lw)
        seen.append(out.requires_grad)
        return out
    run = make_pipeline_train_step(layer, 1, N_MICRO, one_rank)
    for mode in (torch.inference_mode, torch.no_grad):
        seen.clear()
        with mode():
            y = run(w1, x1)
        assert y.grad_fn is None and not y.requires_grad
        assert len(seen) == N_MICRO * w1.shape[1] and not any(seen)
    seen.clear()
    y = run(w1, x1)
    assert y.grad_fn is not None and all(seen)
