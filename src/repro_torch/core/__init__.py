"""The overlay JIT compiler: frontend, mapping, bitstream and program."""

from repro_torch.core.jit import CompiledKernel, jit_compile  # noqa: F401
from repro_torch.core.options import CompileOptions  # noqa: F401
from repro_torch.core.overlay import OverlaySpec  # noqa: F401
