"""Where the package's entry points run.

Every entry point runs on the CUDA card unless the caller asks for the CPU:

  * numpy arrays and python scalars go to ``device`` (default:
    :func:`default_device`, which is ``cuda``);
  * a tensor stays where it lies — a CPU tensor takes the plain PyTorch
    version of a kernel, a CUDA tensor takes the kernel itself.

There is no silent fallback: with no card and no ``device="cpu"`` the call
raises.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def default_device() -> torch.device:
    """The CUDA card; raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: pass device=\"cpu\" to run the "
            "plain PyTorch path on the CPU")
    return torch.device("cuda")


def target_device(inputs: Sequence, device: DeviceLike = None
                  ) -> torch.device:
    """The one device a call runs on: ``device`` if given, else the device
    of the first tensor among ``inputs``, else :func:`default_device`.
    Tensors on any other device are an error, never moved silently."""
    tensors = [x for x in inputs if isinstance(x, torch.Tensor)]
    if device is not None:
        dev = torch.device(device)
    elif tensors:
        dev = tensors[0].device
    else:
        dev = default_device()
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    for t in tensors:        # a CUDA tensor's device always has an index
        if t.device != dev:
            raise ValueError(f"input tensor on {t.device}, call runs on {dev}")
    return dev


def to_tensors(inputs: Sequence, device: DeviceLike = None,
               dtype: Optional[torch.dtype] = torch.float32
               ) -> List[torch.Tensor]:
    """``inputs`` as tensors on one device (see :func:`target_device`).

    Non-tensors are rounded to float32 as numpy does, then cast to
    ``dtype``; tensors are cast to ``dtype`` (``None`` keeps theirs)."""
    dev = target_device(inputs, device)
    out = []
    for x in inputs:
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x, np.float32), device=dev)
        out.append(x if dtype is None else x.to(dtype))
    return out
