"""Building and loading the port's CUDA kernels (``csrc/*.cu``).

Each source is one shared library with a plain C interface: at first use
``nvcc`` compiles it for ``sm_90a`` into the checkout's ``build/``
directory, under a name keyed on the hash of the source and the flags, and
ctypes loads it.  Nothing is compiled, and CUDA is not touched, when a
module is imported.

Every library exports ``<name>_error_string(int)``; its launch functions
return ``cudaGetLastError()``, which :meth:`CudaLibrary.check` turns into
an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
_REPO_ROOT = Path(__file__).resolve().parents[2]

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

# ctypes signature of one exported function: (argtypes, restype)
Signature = Tuple[List, object]


class CudaLibrary:
    """``csrc/<name>.cu`` built and loaded once per process.

    ``functions`` maps each exported launch function to its ctypes
    signature; ``extra_flags`` are added to :data:`NVCC_FLAGS`."""

    def __init__(self, name: str, functions: Dict[str, Signature],
                 extra_flags: Sequence[str] = ()) -> None:
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.flags = NVCC_FLAGS + tuple(extra_flags)
        self._functions = functions
        self._lock = threading.Lock()
        self._lib = None
        self.builds = 0          # libraries built or loaded by this process
        self.build_log = ""      # nvcc's output (ptxas register/smem usage)

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self._lib = self._load()
            return self._lib

    def check(self, err: int, what: str) -> None:
        """Raise when a launch function returned a CUDA error."""
        if err != 0:
            msg = getattr(self.get(), f"{self.name}_error_string")(err)
            raise RuntimeError(f"{what} failed: CUDA error {err} "
                               f"({msg.decode()})")

    def build(self, out_dir: Path) -> Path:
        """The library's path in ``out_dir``, compiled there by ``nvcc``
        unless a build of this source and these flags is already there."""
        src = self.source.read_bytes()
        digest = hashlib.sha256(src + " ".join(self.flags).encode())
        so = out_dir / f"{self.name}_{digest.hexdigest()[:16]}.so"
        if not so.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc(), *self.flags, "-o", str(tmp), str(self.source)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{self.build_log}")
            os.replace(tmp, so)
        return so

    def _load(self) -> ctypes.CDLL:
        lib = ctypes.CDLL(str(self.build(_REPO_ROOT / "build")))
        for fn, (argtypes, restype) in self._functions.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        err = getattr(lib, f"{self.name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self.builds += 1
        return lib


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the port's CUDA kernels")
    return found
