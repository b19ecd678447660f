"""Fault-tolerant checkpointing: ``repro/checkpoint/manager.py`` restated
for trees of tensors, in the same layout on disk, so a checkpoint either
package writes restores in the other.

  * atomic: write to ``step_N.tmp`` then rename — a crash mid-write never
    corrupts the latest checkpoint;
  * self-validating: a manifest with per-array SHA-256 digests is stored and
    re-checked on restore;
  * async: ``save(...)`` snapshots to host memory synchronously and writes
    on a background thread, overlapping I/O with training.  The snapshot is
    always a COPY: the optimizer updates its tensors in place, and a CPU
    tensor's ``.cpu()`` is the same storage, which the writer would race.
    A blocking save takes each array's snapshot just before writing it, so
    the host holds one array at a time, not the whole state;
  * arrays are numbered as ``jax.tree.flatten`` numbers them, dict keys in
    sorted order (:func:`repro_torch.models.common.leaves`);
  * bfloat16 goes to disk as the JAX package writes it, two raw bytes an
    element with ``'<V2'`` in the ``.npy`` header and ``"bfloat16"`` in the
    manifest, through torch views (no ``ml_dtypes``);
  * restore: each array comes back as a tensor on the device of the leaf it
    replaces in ``like`` (the CPU for a non-tensor leaf);
  * retention: keeps the last ``keep`` checkpoints;
  * across ranks (a tree of DTensors): every rank gathers each array whole
    (a collective), rank 0 alone writes it, the files the same bytes as a
    one-rank run's at the same state, and the other ranks wait at a
    barrier; such a save is always blocking.  A restore reads the full
    arrays on every rank and places each by its ``like`` leaf's
    placements.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.models.common import full, leaves, unflatten

# the .npy header descr the JAX package's np.save writes for bfloat16
BF16_DESCR = "<V2"
# array files a restore reads and hashes at once, on threads
READ_AHEAD = 2
# bytes enough to hold any .npy header (version 1.0 allows 65535)
_HEADER_MAX = 65536 + 16


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ---------------------------------------------------------------- save
    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        """Snapshot ``tree`` (nested dicts of tensors) at ``step``."""
        self.wait()  # one in-flight save at a time
        flat = leaves(tree)
        if any(isinstance(x, DTensor) for x in flat):
            self._save_across_ranks(step, tree, flat)
            return
        # async: every snapshot now; blocking: each as it is written
        host = (_snapshot(x) for x in flat) if blocking \
            else [_snapshot(x) for x in flat]
        self._save_host(step, tree, flat, host, blocking)

    def _save_across_ranks(self, step: int, tree: Any, flat: List) -> None:
        """Every rank gathers each leaf whole as rank 0 writes it; the
        others wait for the write at a barrier."""
        host = (_snapshot(x) for x in flat)
        if dist.get_rank() == 0:
            try:
                self._save_host(step, tree, flat, host, blocking=True)
            finally:
                dist.barrier()
        else:
            for _ in host:
                pass
            dist.barrier()

    def _save_host(self, step: int, tree: Any, flat: List, host,
                   blocking: bool) -> None:
        treedef_repr = unflatten(tree, list(range(len(flat))))

        def _write():
            try:
                tmp = os.path.join(self.dir, f"step_{step:010d}.tmp")
                final = os.path.join(self.dir, f"step_{step:010d}")
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                os.makedirs(tmp)
                manifest: Dict[str, Any] = {"step": step, "arrays": []}
                for i, t in enumerate(host):
                    path = os.path.join(tmp, f"arr_{i:05d}.npy")
                    shape, dtype, digest = _save_npy(path, t)
                    manifest["arrays"].append({
                        "i": i, "shape": shape, "dtype": dtype,
                        "sha256": digest})
                manifest["treedef"] = json.dumps(treedef_repr)
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
                self._gc()
            except BaseException as e:   # surfaced on next wait()
                self._error = e

        if blocking:
            _write()
            self._raise_if_failed()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError(f"async checkpoint write failed: {e!r}")

    def _gc(self) -> None:
        steps = self.available_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # -------------------------------------------------------------- restore
    def available_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def _arrays(self, step: int, metas) -> Iterator[torch.Tensor]:
        """The arrays of ``step`` as CPU tensors, in index order, each
        checked against its digest first.  Files are read and hashed
        ``READ_AHEAD`` at a time on threads; each is read once."""
        d = os.path.join(self.dir, f"step_{step:010d}")
        with ThreadPoolExecutor(READ_AHEAD) as ex:
            pending = [ex.submit(_read_npy, d, m)
                       for m in metas[:READ_AHEAD]]
            for j in range(len(metas)):
                t = pending[j].result()
                pending[j] = None
                if j + READ_AHEAD < len(metas):
                    pending.append(ex.submit(_read_npy, d,
                                             metas[j + READ_AHEAD]))
                yield t

    def restore(self, step: int, like: Any) -> Any:
        """Restore arrays for ``step`` into the structure of ``like`` (a
        tree of the same structure; its leaves give only the device)."""
        d = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            metas = json.load(f)["arrays"]
        flat_like = leaves(like)
        if len(flat_like) != len(metas):
            raise ValueError(f"checkpoint has {len(metas)} arrays, expected "
                             f"{len(flat_like)}")
        out = []
        for t, ref in zip(self._arrays(step, metas), flat_like):
            device = ref.device if isinstance(ref, torch.Tensor) else "cpu"
            t = t.to(device)
            if isinstance(ref, DTensor):
                t = distribute_tensor(t, ref.device_mesh, ref.placements,
                                      src_data_rank=None)
            out.append(t)
        return unflatten(like, out)

    def restore_latest(self, like: Any) -> Optional[Tuple[int, Any]]:
        steps = self.available_steps()
        if not steps:
            return None
        return steps[-1], self.restore(steps[-1], like)


def _snapshot(x: Any) -> torch.Tensor:
    """A host copy of a leaf, never sharing its storage (a DTensor's
    gathered whole: a collective)."""
    if isinstance(x, DTensor):
        x = full(x)
    t = torch.as_tensor(x)
    return t.detach().to("cpu", copy=True)


def _save_npy(path: str, t: torch.Tensor) -> Tuple[List[int], str, str]:
    """Write ``t`` byte for byte as the JAX package's ``np.save`` writes
    the same array → (shape, the manifest's dtype name, the file's
    SHA-256), hashing the bytes as they are written."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        arr, name = t.view(torch.int16).numpy(), "bfloat16"
        header = {"descr": BF16_DESCR, "fortran_order": False,
                  "shape": tuple(t.shape)}
    else:
        arr, name = t.numpy(), str(t.numpy().dtype)
        header = np.lib.format.header_data_from_array_1_0(arr)
    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(buf, header)
    digest = hashlib.sha256(buf.getvalue())
    data = memoryview(arr.reshape(-1)).cast("B")
    digest.update(data)
    with open(path, "wb") as f:
        f.write(buf.getvalue())
        f.write(data)
    return list(t.shape), name, digest.hexdigest()


def _read_npy(directory: str, meta: Dict[str, Any]) -> torch.Tensor:
    """One array file of a checkpoint, read once into a writable buffer,
    checked against its digest → a CPU tensor on that buffer."""
    path = os.path.join(directory, f"arr_{meta['i']:05d}.npy")
    buf = bytearray(os.path.getsize(path))
    with open(path, "rb") as f:
        f.readinto(buf)
    if hashlib.sha256(buf).hexdigest() != meta["sha256"]:
        raise ValueError(f"digest mismatch in {path} — corrupt checkpoint")
    fp = io.BytesIO(memoryview(buf)[:_HEADER_MAX])   # the header only
    version = np.lib.format.read_magic(fp)
    read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
            else np.lib.format.read_array_header_2_0)
    shape, fortran, dtype = read(fp)
    if fortran:                 # neither package writes Fortran order
        raise ValueError(f"{path}: a Fortran-ordered array")
    if meta["dtype"] == "bfloat16":
        tdtype = torch.bfloat16
    else:
        if str(dtype) != meta["dtype"]:
            raise ValueError(f"{path}: {dtype}, manifest says "
                             f"{meta['dtype']}")
        tdtype = torch.from_numpy(np.empty(0, dtype)).dtype
    n = int(np.prod(shape, dtype=np.int64))
    if n == 0:
        return torch.empty(shape, dtype=tdtype)
    return torch.frombuffer(buf, dtype=tdtype, count=n,
                            offset=fp.tell()).view(shape)
