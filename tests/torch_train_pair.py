"""One reduced model's train state built by the JAX package and carried
into the port with ``state_from_numpy``, and one batch made with numpy,
for ``tests/test_torch_train*.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as r_configs
from repro.models.registry import build_model as r_build_model
from repro.optim import adamw as r_adamw
from repro.train.step import init_state as r_init_state
from repro_torch.configs import registry as configs
from repro_torch.models.common import leaves, state_from_numpy
from repro_torch.models.registry import build_model
from repro_torch.train.step import value_and_grad

F32_TOL = 1e-4
KEY = jax.random.PRNGKey(0)
_CACHE = {}


def pair(arch: str, remat_policy: str = "full", **levers):
    """→ (JAX model, JAX state, port config, port model, port state); the
    JAX model without remat (its gradients do not depend on it), the
    port's with ``remat_policy``.  The port's state is a fresh copy."""
    key = (arch, tuple(sorted(levers.items())))
    if key not in _CACHE:
        r_cfg = dataclasses.replace(
            r_configs.reduced_config(r_configs.ALL_ARCHS[arch]),
            dtype=jnp.float32)
        r_model = r_build_model(r_cfg, remat_policy="none", **levers)
        # jit only to build faster: the draws are the eager ones
        r_state = jax.jit(lambda k: r_init_state(r_model, k))(KEY)
        _CACHE[key] = (r_model, r_state,
                       jax.tree.map(np.asarray, r_state))
    r_model, r_state, np_state = _CACHE[key]
    cfg = dataclasses.replace(configs.reduced_config(configs.ALL_ARCHS[arch]),
                              dtype=torch.float32)
    model = build_model(cfg, remat_policy=remat_policy, **levers)
    return r_model, r_state, cfg, model, state_from_numpy(np_state, cfg,
                                                          "cpu")


def batch(cfg, b: int = 2, s: int = 16, seed: int = 0):
    """Token ids and next-token labels (numpy), with the stub frontends'
    embeddings where the family takes them."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.frontend == "vision":
        out["input_embeds"] = rng.standard_normal(
            (b, max(1, s // 8), cfg.d_model)).astype(np.float32)
    if cfg.frontend == "audio":
        out["input_embeds"] = rng.standard_normal(
            (b, 2 * s, cfg.d_model)).astype(np.float32)
    return out


def check_gradients(arch: str, remat_policy: str = "full", **levers):
    """The port's loss and every gradient against
    ``jax.value_and_grad(model.loss)`` on the same state and batch, and
    its train step's loss and grad_norm against the JAX package's, all
    within F32_TOL in float32."""
    r_model, r_state, cfg, model, state = pair(arch, remat_policy, **levers)
    b = batch(cfg)
    jb = jax.tree.map(jnp.asarray, b)
    r_loss, r_grads = jax.jit(jax.value_and_grad(r_model.loss))(
        r_state["params"], jb)
    loss, grads = value_and_grad(
        model, state["params"], {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=F32_TOL,
                               atol=F32_TOL)
    got, want = leaves(grads), jax.tree.leaves(r_grads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=F32_TOL,
                                   atol=F32_TOL)
    _, r_gn = r_adamw.clip_by_global_norm(r_grads, 1.0)
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import make_train_step
    _, metrics = make_train_step(model, AdamWConfig())(state, b)
    np.testing.assert_allclose(float(metrics["loss"]), float(r_loss),
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(r_gn),
                               rtol=F32_TOL, atol=F32_TOL)
    assert int(metrics["step"]) == 1
