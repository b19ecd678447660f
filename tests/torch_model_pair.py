"""One reduced model built by both packages, with the JAX parameters carried
across by ``params_from_numpy`` (no RNG is re-derived), for the family
tests ``test_torch_moe.py`` and ``test_torch_mamba2.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as r_configs
from repro.models.registry import build_model as r_build_model
from repro_torch.configs import registry as configs
from repro_torch.models.common import params_from_numpy
from repro_torch.models.registry import build_model

F32_TOL = 1e-4
BF16_TOL = 5e-2
KEY = jax.random.PRNGKey(0)

# JAX model init is the slow part: build each (arch, dtype, levers,
# config changes) once; the tests only read the parameters
_CACHE = {}


@dataclasses.dataclass(frozen=True)
class Pair:
    r_model: object
    r_params: dict
    cfg: object
    model: object
    params: dict


def pair(arch: str, dtype: str = "float32", replace=(), **levers) -> Pair:
    """``replace``: (field, value) pairs changed in both reduced configs;
    ``levers``: ``build_model`` keywords given to both packages."""
    key = (arch, dtype, tuple(replace), tuple(sorted(levers.items())))
    if key not in _CACHE:
        r_cfg = dataclasses.replace(
            r_configs.reduced_config(r_configs.ALL_ARCHS[arch]),
            dtype=getattr(jnp, dtype), **dict(replace))
        cfg = dataclasses.replace(
            configs.reduced_config(configs.ALL_ARCHS[arch]),
            dtype=getattr(torch, dtype), **dict(replace))
        r_model = r_build_model(r_cfg, remat_policy="none", **levers)
        # jit only to build faster: the draws are the eager ones
        r_params = jax.jit(r_model.init)(KEY)
        params = params_from_numpy(jax.tree.map(np.asarray, r_params), cfg,
                                   "cpu")
        _CACHE[key] = Pair(r_model, r_params, cfg,
                           build_model(cfg, **levers), params)
    return _CACHE[key]


def tokens(cfg, b=2, s=16, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


def as_f32(a) -> np.ndarray:
    """A torch tensor (any device, any dtype) or a JAX/numpy array as a
    float32 numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a, np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=tol, atol=tol)


def decode_both(p: Pair, toks: np.ndarray, cache_dtype=None):
    """Feed ``toks`` (B, S) one at a time through both packages'
    ``forward_decode`` (the JAX one jitted) → (JAX logits (S, B, V),
    port logits (S, B, V), JAX cache, port cache)."""
    b, s = toks.shape
    r_cache = p.r_model.init_cache(
        b, s, dtype=None if cache_dtype is None else getattr(jnp,
                                                             cache_dtype))
    cache = p.model.init_cache(
        b, s, dtype=None if cache_dtype is None else getattr(torch,
                                                             cache_dtype))
    r_step = jax.jit(p.r_model.forward_decode)
    want, got = [], []
    for i in range(s):
        r_logits, r_cache = r_step(p.r_params, r_cache,
                                   jnp.asarray(toks[:, i:i + 1]),
                                   jnp.int32(i))
        logits, cache = p.model.forward_decode(
            p.params, cache, torch.from_numpy(toks[:, i:i + 1]), i)
        assert logits.shape == (b, 1, p.cfg.vocab_padded)
        want.append(np.asarray(r_logits, np.float32)[:, 0])
        got.append(logits[:, 0].float().numpy())
    return np.stack(want), np.stack(got), r_cache, cache
