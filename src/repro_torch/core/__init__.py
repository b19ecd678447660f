"""The overlay JIT compiler and its OpenCL-style runtime: frontend,
mapping, bitstream and program; compile cache, command queues, recorded
graphs and the Session facade."""

from repro_torch.core.cache import JITCache, make_cache_key  # noqa: F401
from repro_torch.core.faults import (CorruptedFault,  # noqa: F401
                                     DeviceLostError, FaultPlan, FaultRule,
                                     InjectedFault)
from repro_torch.core.graph import KernelGraph, partition_graph  # noqa: F401
from repro_torch.core.jit import CompiledKernel, jit_compile  # noqa: F401
from repro_torch.core.options import CompileOptions  # noqa: F401
from repro_torch.core.overlay import OverlaySpec  # noqa: F401
from repro_torch.core.recovery import (CircuitBreaker,  # noqa: F401
                                       RecoveryStats, RetryPolicy)
from repro_torch.core.remote import (CompileFarm,  # noqa: F401
                                     RemoteBlobStore, RemoteCache,
                                     RemoteEndpoint, RemoteUnavailable)
from repro_torch.core.session import (GraphExec, KernelFuture,  # noqa: F401
                                      Session)
