"""The port's int8 error-feedback compression and compressed data-parallel
step (``repro_torch.optim.compression``, ``repro_torch.train.dp_compressed``)
against the JAX package's.

The compression is held bit for bit on identical inputs.  The step runs
on 1, 2 and 4 gloo ranks against the reference's ``shard_map`` step on
host meshes of 1, 2 and 4 devices (a child interpreter, see
``tests/torch_dist_pair.py``), from one initial state, for three steps.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.optim import compression as r_compression
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.common import leaves
from repro_torch.optim import compression
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.dp_compressed import (init_compressed_state,
                                             make_compressed_dp_train_step)
from torch_dist_pair import (DP_BATCH, DP_OPT, DP_SEQ, dp_model, dp_rank,
                             flat, jax_running, nested, spawn)

STEPS = 3
# the reference's step on the same state, over make_host_mesh() of as many
# CPU devices as the port has ranks; each device's ef is its own copy
JAX_DP = """
import dataclasses, json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.registry import ALL_ARCHS, reduced_config
from repro.data.pipeline import SyntheticTokens
from repro.launch.mesh import make_host_mesh
from repro.models.registry import build_model
from repro.optim.adamw import AdamWConfig
from repro.train.dp_compressed import make_compressed_dp_train_step

out, steps, n = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
arch, seq, batch = sys.argv[4], int(sys.argv[5]), int(sys.argv[6])
opt = json.loads(sys.argv[7])


def nested(arrays):
    tree = {}
    for key in arrays.keys():
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(arrays[key])
    return tree


def flat(tree, prefix=""):
    return {prefix + "/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


cfg = dataclasses.replace(reduced_config(ALL_ARCHS[arch]),
                          dtype=jnp.float32)
model = build_model(cfg, remat_policy="none")
mesh = make_host_mesh()
assert mesh.devices.shape == (n, 1)
res = {}
state = jax.device_put(nested(np.load(f"{out}/init.npz")),
                       NamedSharding(mesh, P()))
step = make_compressed_dp_train_step(model, AdamWConfig(**opt), mesh)
ds = SyntheticTokens(cfg.vocab, seq, batch, seed=0)
losses, norms = [], []
for i in range(steps):
    state, m = step(state, {k: jnp.asarray(v)
                            for k, v in ds.batch_at(i).items()})
    losses.append(float(m["loss"]))
    norms.append(float(m["grad_norm"]))
res["losses"], res["grad_norms"] = np.array(losses), np.array(norms)
res.update(flat(state["params"], "params/"))
for path, leaf in jax.tree_util.tree_flatten_with_path(state["ef"])[0]:
    key = "/".join(str(k.key) for k in path)
    by_device = {sh.device: np.asarray(sh.data)
                 for sh in leaf.addressable_shards}
    for r, d in enumerate(mesh.devices[:, 0]):
        res[f"ef{r}/{key}"] = by_device[d]
np.savez(f"{out}/jax.npz", **res)
"""


def _keys(npz, prefix):
    return sorted(k for k in npz.keys() if k.startswith(prefix))


@pytest.fixture
def one_rank():
    """A one-rank gloo group for the duration of a test."""
    mesh = make_host_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


# ------------------------------------------------------------ compression

def test_int8_compression_error_feedback_converges():
    """tests/test_substrate.py's check through both packages on one numpy
    gradient: the mean sent over 20 repeats is within 2e-2 of g, and every
    repeat's q, scale and error feedback equal the reference's bit for
    bit."""
    g = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    tg = {"w": torch.from_numpy(g)}
    err, total = {"w": torch.zeros(1000)}, torch.zeros(1000)
    r_err = {"w": jnp.zeros(1000, jnp.float32)}
    for _ in range(20):
        q, s, err = compression.compress_pytree(tg, err)
        rq, rs, r_err = r_compression.compress_pytree({"w": jnp.asarray(g)},
                                                      r_err)
        assert q["w"].dtype == torch.int8
        np.testing.assert_array_equal(q["w"].numpy(), np.asarray(rq["w"]))
        np.testing.assert_array_equal(s["w"].numpy(), np.asarray(rs["w"]))
        np.testing.assert_array_equal(err["w"].numpy(),
                                      np.asarray(r_err["w"]))
        total += compression.decompress_pytree(q, s)["w"]
    np.testing.assert_allclose(total.numpy() / 20, g, atol=2e-2)


def test_int8_quantization_relative_error():
    x = np.asarray(jnp.linspace(-3, 3, 512))
    q, s, _ = compression.compress_pytree({"w": torch.from_numpy(x)},
                                          {"w": torch.zeros(512)})
    rq, rs, _ = r_compression.compress_pytree({"w": jnp.asarray(x)},
                                              {"w": jnp.zeros(512)})
    deq = compression.decompress_pytree(q, s)["w"].numpy()
    np.testing.assert_allclose(deq, x, atol=float(s["w"]) * 0.51)
    np.testing.assert_array_equal(
        deq, np.asarray(r_compression.decompress_pytree(rq, rs)["w"]))
    assert int(q["w"].abs().max()) == 127


def test_error_feedback_allreduce_on_one_rank_matches_the_reference(
        one_rank):
    """The reduction over a one-rank group against the reference's inside
    ``shard_map`` over one device, bit for bit, on one tree of a float32
    and a bfloat16 leaf with a carried error; the error is updated in
    place and each gradient leaf leaves ``grads`` as it is reduced."""
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    rng = np.random.default_rng(1)
    g = {"a": rng.standard_normal((64, 48)).astype(np.float32),
         "b": {"c": rng.standard_normal(300).astype(np.float32)}}
    e = {"a": 1e-3 * rng.standard_normal((64, 48)).astype(np.float32),
         "b": {"c": np.zeros(300, np.float32)}}
    jg = {"a": jnp.asarray(g["a"]),
          "b": {"c": jnp.asarray(g["b"]["c"]).astype(jnp.bfloat16)}}
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    fn = shard_map(lambda gg, ee: r_compression.error_feedback_allreduce(
        gg, ee, "data"), mesh=mesh, in_specs=(P(), P()),
        out_specs=(P(), P()), check_vma=False)
    want_red, want_e = fn(jg, jax.tree.map(jnp.asarray, e))   # eager
    tg = {"a": torch.from_numpy(g["a"]),
          "b": {"c": torch.from_numpy(g["b"]["c"]).to(torch.bfloat16)}}
    te = {"a": torch.from_numpy(e["a"].copy()),
          "b": {"c": torch.zeros(300)}}
    e_leaves = leaves(te)
    red, new_e = compression.error_feedback_allreduce(
        tg, te, one_rank["data"].get_group())
    assert tg == {"b": {}} and new_e is te
    assert all(a is b for a, b in zip(leaves(new_e), e_leaves))
    for got, want in zip(leaves(red) + leaves(new_e),
                         jax.tree.leaves(want_red) + jax.tree.leaves(want_e)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -------------------------------------------------- the compressed step

# Limits of the three-step comparison.  Both sides start from one state
# and batch; the gradients differ in their float32 rounding (XLA's sums
# and torch's), and at 2 and 4 ranks the all-reduce sums in another order
# than XLA's psum.  A gradient a last bit away rounds q to the
# neighbouring quantum where g / scale lies at .5: that element's error
# feedback then differs by one quantum (a scale, 1/127 of the leaf's
# largest gradient; 2 max |ef| bounds it) and its reduced gradient by a
# quantum over the ranks.  The next step's quantum is another size, so
# such an element carries a remnant (up to 0.3 of a quantum read) after
# it; elsewhere the ef differ by the gradients' rounding, under 1e-2 of a
# quantum.  AdamW moves an element by at most about lr (1e-3) a step
# whatever its gradient, so a flipped quantum moves a parameter by less
# than 3 lr over the run.  Read on the CPU: losses 1.4e-6, grad norms
# 8.6e-6 apart (relative), parameters 8.5e-4, and elements of ef more
# than 1e-2 of a quantum apart 4.7e-5 to 9.4e-5 of all, none more than a
# quantum.  The limits: losses 1e-4 and grad norms 1e-4 (float32 sums),
# parameters 3 lr, each ef within a quantum of its reference, and a
# thousandth of the ef elements more than 1e-2 of a quantum away.
LIMITS = {"loss": 1e-4, "grad_norm": 1e-4, "params": 3 * DP_OPT["lr"],
          "ef_quanta": 1.001, "moved_share": 1e-3}


def _readings(port, want, n):
    """One run against the reference's → {reading: value}, each held to
    its LIMITS entry."""
    out = {"loss": float(np.abs(port[0]["losses"] - want["losses"]).max()),
           "grad_norm": float(np.abs(port[0]["grad_norms"]
                                     / want["grad_norms"] - 1).max()),
           "params": max(float(np.abs(port[0][k] - want[k]).max())
                         for k in _keys(port[0], "params/")),
           "ef_quanta": 0.0}
    moved = elements = 0
    for r in range(n):
        for key in _keys(port[r], "ef/"):
            got, ref = port[r][key], want[f"ef{r}/{key[3:]}"]
            quantum = 2 * max(np.abs(ref).max(), np.abs(got).max(), 1e-30)
            diff = np.abs(got - ref)
            out["ef_quanta"] = max(out["ef_quanta"],
                                   float(diff.max() / quantum))
            moved += int((diff > 1e-2 * quantum).sum())
            elements += got.size
    out["moved_share"] = moved / elements
    return out


def _run(tmp_path, n, fault=""):
    """The port's ranks and the reference's step at once, from one state
    → (each rank's arrays, the reference's)."""
    cfg, model = dp_model()
    state = init_compressed_state(model, torch.Generator().manual_seed(0))
    np.savez(tmp_path / "init.npz", **flat(state))
    with jax_running(JAX_DP, n, str(tmp_path), str(STEPS), str(n),
                     "llama3-8b", str(DP_SEQ), str(DP_BATCH),
                     json.dumps(DP_OPT)):
        spawn(dp_rank, n, tmp_path, str(tmp_path / "init.npz"),
              str(tmp_path / "port_%d.npz"), STEPS, fault)
    return ([np.load(tmp_path / f"port_{r}.npz") for r in range(n)],
            np.load(tmp_path / "jax.npz"))


def _tree(npz, prefix):
    return jax.tree.map(jnp.asarray, nested(npz, prefix))


@pytest.mark.parametrize("n", [1, 2, 4])
def test_compressed_step_matches_the_reference_on_n_ranks(n, tmp_path):
    port, want = _run(tmp_path, n)
    # the first step's quantisation of each rank's gradients, by both
    # packages on identical inputs: bit for bit (the reference's functions
    # eagerly: under jit XLA divides by 127 as a product with 1/127, fused
    # with the + 1e-12 at its default optimisation level, a last bit away
    # from the division in about one leaf in ten, PERF.md section 7)
    for r in range(n):
        g = _tree(port[r], "g/")
        rq, rs, _ = r_compression.compress_pytree(
            g, jax.tree.map(jnp.zeros_like, g))
        for got, ref in ((_tree(port[r], "q/"), rq),
                         (_tree(port[r], "s/"), rs)):
            for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # every rank ends with the same parameters and metrics
    for r in range(1, n):
        for key in _keys(port[0], "params/") + ["losses", "grad_norms"]:
            np.testing.assert_array_equal(port[r][key], port[0][key])
    got = _readings(port, want, n)
    assert all(got[k] <= LIMITS[k] for k in LIMITS), got
    if n > 1:       # each rank's ef is its own
        assert any(not np.array_equal(port[0][k], port[1][k])
                   for k in _keys(port[0], "ef/"))


def test_the_limits_catch_an_all_reduce_without_the_division(tmp_path):
    """At 2 ranks, a step whose all-reduce sums the gradients without
    dividing by the group's size.  Clipping and AdamW's normalisation hide
    a gradient scaled by 2 from the parameters; the grad norm shows it."""
    port, want = _run(tmp_path, 2, fault="no_div")
    got = _readings(port, want, 2)
    assert got["grad_norm"] > LIMITS["grad_norm"], got


def test_compressed_dp_matches_uncompressed_convergence(one_rank):
    """tests/test_compressed_dp.py through the port on one rank: both
    curves fall over 30 steps and end within 0.35 of each other."""
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.train.step import init_state, make_train_step
    cfg, model = dp_model()
    opt = AdamWConfig(**DP_OPT)
    ds = SyntheticTokens(cfg.vocab, seq=DP_SEQ, batch=DP_BATCH, seed=0)

    def losses(step, state):
        out = []
        for i in range(30):
            state, m = step(state, ds.batch_at(i))
            out.append(float(m["loss"]))
        return out
    base = losses(make_train_step(model, opt),
                  init_state(model, torch.Generator().manual_seed(0)))
    comp = losses(make_compressed_dp_train_step(model, opt, one_rank),
                  init_compressed_state(model,
                                        torch.Generator().manual_seed(0)))
    assert base[-1] < base[0] and comp[-1] < comp[0]
    assert abs(comp[-1] - base[-1]) < 0.35, (base[-1], comp[-1])


def test_init_compressed_state_adds_float32_zeros_beside_each_parameter():
    cfg = dataclasses.replace(dp_model()[0], dtype=torch.bfloat16)
    from repro_torch.models.registry import build_model
    state = init_compressed_state(build_model(cfg),
                                  torch.Generator().manual_seed(0))
    assert sorted(state) == ["ef", "opt", "params"]
    for e, p in zip(leaves(state["ef"]), leaves(state["params"])):
        assert e.dtype == torch.float32 and e.shape == p.shape
        assert not e.any()
