"""The port's sharding rules and specs against the JAX package's, and the
meshes they place tensors on: every architecture's ``param_specs`` and
``cache_specs``, ``moe_specs``, ``mamba_specs``, ``state_specs`` and
``input_shardings`` leaf by leaf as tuples, ``input_specs``' shapes and
dtypes; ``make_host_mesh`` and ``place`` on the CPU, on one rank and on
two; the launchers on a host mesh."""

import contextlib
import io
import json

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as RP

from repro.configs.registry import ALL_ARCHS as R_ALL_ARCHS
from repro.models import mamba2 as r_mamba2
from repro.models import moe as r_moe
from repro.models import registry as r_registry
from repro.models.common import spec as r_spec
from repro.train.step import state_specs as r_state_specs
from repro_torch.configs.registry import ALL_ARCHS
from repro_torch.launch import serve
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import (ICI_BW, make_host_mesh,
                                     make_production_mesh, place)
from repro_torch.models import mamba2, moe, registry
from repro_torch.models.common import P, leaves, spec
from repro_torch.train.step import state_specs
from torch_dist_pair import mesh_rank, spawn

ARCHS = sorted(ALL_ARCHS)


def as_tuples(tree):
    """A spec tree of either package as nested dicts of plain tuples."""
    if isinstance(tree, dict):
        return {k: as_tuples(v) for k, v in tree.items()}
    assert isinstance(tree, (P, RP)), tree
    return tuple(tree)


def _models(arch):
    return (r_registry.build_model(R_ALL_ARCHS[arch]),
            registry.build_model(ALL_ARCHS[arch]))


def test_the_rules_and_P_normalise_as_the_reference_does():
    assert P(("data",), None) == ("data", None) == tuple(RP(("data",), None))
    assert P(("pod", "data"), None) == (("pod", "data"), None)
    for multi_pod in (False, True):
        for names in (("batch", "seq"), ("vocab", "embed"), (None,),
                      ("kv_seq", "kv_heads", "experts", "ssm_inner")):
            assert spec(*names, multi_pod=multi_pod) == tuple(
                r_spec(*names, multi_pod=multi_pod))


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_every_spec_tree_equals_the_reference(arch, multi_pod):
    r_model, model = _models(arch)
    cfg = ALL_ARCHS[arch]
    got, want = model.param_specs(multi_pod), r_model.param_specs(multi_pod)
    assert as_tuples(got) == as_tuples(want)
    # the tree is the parameters' own: one spec a leaf, of no more
    # entries than the leaf has dimensions
    shapes = jax.eval_shape(r_model.init, jax.random.PRNGKey(0))
    assert len(leaves(got)) == len(jax.tree.leaves(shapes))
    for s, leaf in zip(leaves(got), jax.tree.leaves(shapes)):
        assert len(s) <= leaf.ndim
    assert as_tuples(state_specs(model, multi_pod)) == as_tuples(
        r_state_specs(r_model, multi_pod))
    for seq_sharded in (False, True):
        for model_axis in (16, 4):
            assert as_tuples(model.cache_specs(
                multi_pod, seq_sharded, model_axis)) == as_tuples(
                r_model.cache_specs(multi_pod, seq_sharded, model_axis))
    assert as_tuples(moe.moe_specs(cfg, multi_pod)) == as_tuples(
        r_moe.moe_specs(R_ALL_ARCHS[arch], multi_pod))
    assert as_tuples(mamba2.mamba_specs(cfg, multi_pod)) == as_tuples(
        r_mamba2.mamba_specs(R_ALL_ARCHS[arch], multi_pod))
    for kind in ("train", "prefill", "decode"):
        for batch_size in (None, 32, 1):
            assert as_tuples(registry.input_shardings(
                cfg, kind, multi_pod, batch_size)) == as_tuples(
                r_registry.input_shardings(R_ALL_ARCHS[arch], kind,
                                           multi_pod, batch_size))


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_are_meta_tensors_of_the_reference_shapes(arch):
    for kind in ("train", "prefill", "decode"):
        got = registry.input_specs(ALL_ARCHS[arch], 64, 4, kind)
        want = r_registry.input_specs(R_ALL_ARCHS[arch], 64, 4, kind)
        assert sorted(got) == sorted(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == want[k].shape
            assert str(t.dtype).removeprefix("torch.") == \
                np.dtype(want[k].dtype).name
    with pytest.raises(ValueError, match="unknown kind"):
        registry.input_specs(ALL_ARCHS[arch], 64, 4, "serve")


@pytest.fixture
def no_group():
    """No process group before the test; none left after it."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_host_mesh_and_place_on_one_rank(no_group):
    mesh = make_host_mesh(4, device="cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (1, 1)
    assert dist.get_backend() == "gloo"
    cfg = ALL_ARCHS["qwen3-14b"]
    from repro_torch.configs.registry import reduced_config
    model = registry.build_model(reduced_config(cfg))
    params = model.init(torch.Generator().manual_seed(0))
    placed = place(params, model.param_specs(), mesh)
    for a, b in zip(leaves(placed), leaves(params)):
        assert a is b                      # on the mesh's device already
    with pytest.raises(ValueError, match="mesh axis 'pod'"):
        place(params, model.param_specs(multi_pod=False) | {"lm": {
            k: P("pod") for k in params["lm"]}}, mesh)
    with pytest.raises(ValueError, match="another structure"):
        place(params, {"lm": model.param_specs()["lm"]}, mesh)
    with pytest.raises(ValueError, match="needs 256 ranks"):
        make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="needs 512 ranks"):
        make_production_mesh(multi_pod=True, device="cpu")
    assert ICI_BW == 450e9


def test_an_axis_above_one_raises_on_two_ranks(tmp_path):
    """On two gloo ranks: model_shards 1 gives (2, 1) and a batch spec on
    'data' raises; model_shards 2 gives (1, 2) and the parameters' specs
    on 'model' raise, naming the next slice; the training launcher raises
    for its data axis of 2."""
    spawn(mesh_rank, 2, tmp_path, str(tmp_path / "mesh_%d.json"))
    for r in range(2):
        res = json.loads((tmp_path / f"mesh_{r}.json").read_text())
        assert res["shape_1"] == [2, 1] and res["shape_2"] == [1, 2]
        assert "model-axis execution through DTensor" in res["batch"]
        assert "model-axis execution through DTensor" in res["params"]
        assert "a data axis above 1 in launch/train.py" in res["train"]


def test_launch_train_on_a_host_mesh_of_four_model_shards(no_group, capsys):
    out = launch_train.main(["--arch", "qwen3-14b", "--reduced", "--steps",
                             "2", "--batch", "2", "--seq", "16",
                             "--model-shards", "4"], device="cpu")
    assert out["final_step"] == 2
    assert "mesh={'data': 1, 'model': 1} device=cpu" in capsys.readouterr().out
    assert not dist.is_initialized()        # the launcher ended its group


def test_legacy_serve_places_on_the_host_mesh(no_group):
    import argparse
    outs = []
    for shards in (1, 4):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve._legacy_main(argparse.Namespace(
                arch="qwen3-14b", reduced=True, batch=2, prompt_len=3, gen=2,
                temperature=0.0, device="cpu", model_shards=shards))
        outs.append([line for line in buf.getvalue().splitlines()
                     if line.startswith("sample:")])
    assert outs[0] and outs[0] == outs[1]
    assert not dist.is_initialized()
