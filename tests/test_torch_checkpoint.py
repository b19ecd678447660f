"""The port's checkpoint manager against the JAX package's.

Both write the same files: ``step_N`` (via ``step_N.tmp``), one ``.npy``
an array numbered in sorted-key order, a manifest with a SHA-256 each.
So the files are compared byte for byte, and a checkpoint either package
wrote restores in the other, bfloat16 leaves included.  Also: round trip,
corruption, retention, the asynchronous write and its snapshot copy.
"""

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as RManager
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.models.common import array_to_tensor, leaves, tree_map


def _arrays(seed=0):
    """A train-state-like tree of numpy arrays, keys out of sorted order:
    float32, bfloat16, int32, a 0-d step and an empty leaf."""
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal((4, 6)).astype(
                           ml_dtypes.bfloat16),
                       "b": rng.standard_normal(6).astype(np.float32)},
            "opt": {"step": np.array(7, np.int32),
                    "mu": rng.standard_normal((4, 6)).astype(np.float32),
                    "ids": np.arange(5, dtype=np.int32),
                    "empty": np.zeros((0, 3), np.float32)}}


def _tensors(arrays):
    return tree_map(lambda a: array_to_tensor(a), arrays)


def _same(tensors, arrays):
    for t, a in zip(leaves(tensors), jax.tree.leaves(arrays)):
        a = np.asarray(a)
        assert tuple(t.shape) == a.shape
        if a.dtype == ml_dtypes.bfloat16:
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          a.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), a)


def _step_dir(root, step):
    return os.path.join(root, f"step_{step:010d}")


def test_round_trip(tmp_path):
    arrays = _arrays()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, _tensors(arrays), blocking=True)
    assert mgr.available_steps() == [3]
    step, back = mgr.restore_latest(_tensors(_arrays(1)))
    assert step == 3
    _same(back, arrays)
    manifest = json.load(open(os.path.join(_step_dir(tmp_path, 3),
                                           "manifest.json")))
    dtypes = [m["dtype"] for m in manifest["arrays"]]
    # sorted keys: opt/{empty, ids, mu, step}, params/{b, w}
    assert dtypes == ["float32", "int32", "float32", "int32", "float32",
                      "bfloat16"]
    assert CheckpointManager(str(tmp_path / "none")).restore_latest(
        arrays) is None


def test_files_are_the_reference_files_byte_for_byte(tmp_path):
    arrays = _arrays()
    RManager(str(tmp_path / "ref")).save(
        5, jax.tree.map(jnp.asarray, arrays), blocking=True)
    CheckpointManager(str(tmp_path / "port")).save(5, _tensors(arrays),
                                                   blocking=True)
    ref, port = _step_dir(tmp_path / "ref", 5), _step_dir(tmp_path / "port",
                                                          5)
    names = sorted(os.listdir(ref))
    assert names == sorted(os.listdir(port))
    assert "manifest.json" in names and len(names) == 7
    for name in names:
        with open(os.path.join(ref, name), "rb") as a, \
                open(os.path.join(port, name), "rb") as b:
            assert a.read() == b.read(), name


def test_a_reference_checkpoint_restores_in_the_port(tmp_path):
    arrays = _arrays(2)
    RManager(str(tmp_path)).save(9, jax.tree.map(jnp.asarray, arrays),
                                 blocking=True)
    back = CheckpointManager(str(tmp_path)).restore(9, _tensors(_arrays()))
    _same(back, arrays)


def test_a_port_checkpoint_restores_in_the_reference(tmp_path):
    arrays = _arrays(3)
    CheckpointManager(str(tmp_path)).save(9, _tensors(arrays),
                                          blocking=True)
    back = RManager(str(tmp_path)).restore(9, _arrays())
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(arrays)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.reshape(-1).view(np.uint8),
                                      want.reshape(-1).view(np.uint8))


def test_a_corrupt_array_is_refused(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tensors(_arrays()), blocking=True)
    path = os.path.join(_step_dir(tmp_path, 1), "arr_00002.npy")
    data = bytearray(open(path, "rb").read())
    data[-1] ^= 0xFF
    open(path, "wb").write(data)
    with pytest.raises(ValueError, match="digest mismatch"):
        mgr.restore(1, _tensors(_arrays()))


def test_a_structure_mismatch_is_refused(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tensors(_arrays()), blocking=True)
    like = _tensors(_arrays())
    del like["opt"]["ids"]
    with pytest.raises(ValueError, match="expected 5"):
        mgr.restore(1, like)


def test_retention_keeps_the_last_checkpoints(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, _tensors(_arrays(step)))
    mgr.wait()
    assert mgr.available_steps() == [3, 4]
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(
        _step_dir(tmp_path, s)) for s in (3, 4)]
    _same(mgr.restore(3, _tensors(_arrays())), _arrays(3))


def test_async_save_snapshots_a_copy(tmp_path):
    """The optimizer updates its tensors in place right after a save; the
    background write must see the state as it was at the save."""
    arrays = _arrays(4)
    state = _tensors(arrays)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, state)                   # returns before the write ends
    for t in leaves(state):
        if t.is_floating_point():
            t.mul_(-3).add_(1)
        else:
            t.add_(100)
    mgr.wait()
    _same(mgr.restore(2, state), arrays)


def test_an_async_failure_surfaces_on_the_next_wait(tmp_path):
    root = tmp_path / "ckpt"
    mgr = CheckpointManager(str(root))
    root.rmdir()
    root.write_text("not a directory")      # the write cannot make step_1
    mgr.save(1, _tensors(_arrays()))
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        mgr.wait()
    mgr.wait()                           # reported once


def test_restore_places_arrays_like_the_leaves(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tensors(_arrays()), blocking=True)
    like = tree_map(lambda a: torch.empty(0, device="meta"), _arrays())
    back = mgr.restore(1, like)
    assert {t.device.type for t in leaves(back)} == {"meta"}
