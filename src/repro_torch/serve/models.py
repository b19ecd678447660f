"""The model zoo as captured kernel graphs over the overlay JIT.

Each model family of the zoo (``src/repro/models/`` in the JAX package)
has a characteristic *layer pipeline* whose pointwise datapaths are
overlay-expressible (the DSP ops: ±, ×, min/max/abs and immediates —
exactly the vocabulary :mod:`repro_torch.models.overlay_ops` already JITs
one kernel at a time).  This module expresses those pipelines as
**recorded kernel graphs**: one *prefill* graph (prompt state in →
decode state out, the deep pass) and one *decode* graph (state in →
state out, the per-step pass) per family, captured through
:meth:`Session.capture` and instantiated through the normal cached/fused
compile path.

Because instantiation rides the ordinary
:class:`~repro_torch.core.cache.JITCache`, a served model warm-starts
exactly like any other kernel: re-instantiating in-process is a
memory-tier hit, a restarted host warms from the disk tier, and a fresh
host in a fleet warms from the remote tier — the model zoo inherits the
whole cache story for free.

Every stage is **elementwise** over the state vector.  That is the load-
bearing property of the serving subsystem: running a stage over the
concatenation of several requests' states is bit-identical to running it
over each state alone, so continuous batching (concat → one launch) can
never change a tenant's numerics.  ``STAGE_KERNELS`` registers every
stage (name → (callable, arity)) so the static analyzer sweeps exactly
the kernels the server executes (``python -m repro.analysis`` in the JAX
package; the port's analyzer arrives with the analysis item of ROADMAP.md
§1), mirroring ``overlay_ops.KERNELS``.

In the port every launch runs the CUDA overlay executor on the resident
image of each fused partition, on the Session's device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

from repro_torch.core.graph import KernelGraph
from repro_torch.core.options import CompileOptions
from repro_torch.core.session import GraphExec, Session

# ----------------------------------------------------------- stage kernels
#
# Pure overlay datapaths (DSP ops only — the tracer in repro_torch.core.dfg
# supports +, -, *, neg, abs, min, max and float immediates).  Named
# module-level functions keep DFG fingerprints stable across captures,
# processes and hosts, which is what makes the prefill/decode graphs
# warm-startable through the disk/remote cache tiers.


def _qk_scale(x):
    """Pre-attention scaling (1/sqrt(d) analogue with a learned bias)."""
    return x * 0.125 + 0.02


def _attn_mix(x):
    """Quadratic token-mixing datapath (score*value polynomial)."""
    return (x * x) * 0.5 + x * 0.8


def _sq_relu(x):
    """max(x,0)^2 — the squared-relu FFN activation (nemotron-4)."""
    return x.max(0.0) * x.max(0.0)


def _ffn_gate(x):
    """Gated FFN datapath: relu gate times a linear up-projection."""
    return x.max(0.0) * (x * 0.7 + 0.3)


def _residual(x, r):
    return x + r


def _moe_route(x):
    """Router logit squashed into [-1, 1] (clamped linear gate)."""
    return (x * 0.2).min(1.0).max(-1.0)


def _expert_a(x):
    return (x * x) * 0.4 + x * 0.5 - 0.1


def _expert_b(x):
    return x * 0.9 - (x * x) * 0.2 + 0.05


def _moe_mix(g, a, b):
    """g*a + (1-g)*b — top-2 expert blend under the router gate."""
    return g * a - g * b + b


def _ssm_decay(x):
    """Diagonal state decay (the A-bar multiply of SSD)."""
    return x * 0.9 + 0.01


def _ssm_update(s, u):
    """State update: decayed state plus the input injection (B-bar u)."""
    return s * 0.8 + u * 0.3


def _ssm_gate(y, z):
    """Output gate y * relu(z) (the silu gate's overlay-expressible part)."""
    return y * z.max(0.0)


def _conv_smooth(x):
    """Conv-frontend smoothing datapath (whisper's mel stem analogue)."""
    return x * 0.6 + abs(x) * 0.2


def _spec_norm(x):
    """Clamped spectral normalization ([-4, 4] range clip)."""
    return x.min(4.0).max(-4.0)


def _out_norm(x):
    """Output normalizer: every pipeline's final stage.  Halve and clamp
    to [-1, 1] so the decode map is a bounded self-map — iterating it any
    number of steps stays finite (no overflow), which keeps the
    bit-identity contract meaningful over long generations."""
    return (x * 0.5).min(1.0).max(-1.0)


# name -> (traceable callable, arity); swept by the static analyzer
STAGE_KERNELS: Dict[str, Tuple[Callable, int]] = {
    "qk_scale": (_qk_scale, 1),
    "attn_mix": (_attn_mix, 1),
    "sq_relu": (_sq_relu, 1),
    "ffn_gate": (_ffn_gate, 1),
    "residual": (_residual, 2),
    "moe_route": (_moe_route, 1),
    "expert_a": (_expert_a, 1),
    "expert_b": (_expert_b, 1),
    "moe_mix": (_moe_mix, 3),
    "ssm_decay": (_ssm_decay, 1),
    "ssm_update": (_ssm_update, 2),
    "ssm_gate": (_ssm_gate, 2),
    "conv_smooth": (_conv_smooth, 1),
    "spec_norm": (_spec_norm, 1),
    "out_norm": (_out_norm, 1),
}


# -------------------------------------------------------- family pipelines

@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """One model family's serving shape: its state width and the two graph
    bodies.  A body is a callable ``(call, x) -> out`` where ``call(name,
    *bufs)`` records stage ``name`` from :data:`STAGE_KERNELS`."""
    family: str
    state_dim: int
    prefill: Callable
    decode: Callable


def _transformer_prefill(call, x):
    # two dense layers' worth of pointwise datapath over the prompt state
    h = call("qk_scale", x)
    a = call("attn_mix", h)
    r = call("residual", a, x)
    f = call("sq_relu", r)
    r2 = call("residual", f, r)
    a2 = call("attn_mix", r2)
    return call("out_norm", call("residual", a2, r2))


def _transformer_decode(call, x):
    h = call("qk_scale", x)
    a = call("attn_mix", h)
    r = call("residual", a, x)
    f = call("ffn_gate", r)
    return call("out_norm", call("residual", f, r))


def _moe_prefill(call, x):
    g = call("moe_route", x)
    ea = call("expert_a", x)
    eb = call("expert_b", x)
    m = call("moe_mix", g, ea, eb)
    r = call("residual", m, x)
    a = call("attn_mix", r)
    return call("out_norm", call("residual", a, r))


def _moe_decode(call, x):
    g = call("moe_route", x)
    ea = call("expert_a", x)
    eb = call("expert_b", x)
    m = call("moe_mix", g, ea, eb)
    return call("out_norm", call("residual", m, x))


def _mamba2_prefill(call, x):
    d = call("ssm_decay", x)
    u = call("ssm_update", d, x)
    d2 = call("ssm_decay", u)
    u2 = call("ssm_update", d2, u)
    return call("out_norm", call("ssm_gate", u2, x))


def _mamba2_decode(call, x):
    d = call("ssm_decay", x)
    u = call("ssm_update", d, x)
    return call("out_norm", call("ssm_gate", u, x))


def _whisper_prefill(call, x):
    # encoder: conv stem + spectral clamp + two mixing layers
    c = call("conv_smooth", x)
    n = call("spec_norm", c)
    a = call("attn_mix", n)
    r = call("residual", a, n)
    f = call("sq_relu", r)
    return call("out_norm", call("residual", f, r))


def _whisper_decode(call, x):
    # decoder step: self-attn datapath + cross-attn datapath + residual
    h = call("qk_scale", x)
    a = call("attn_mix", h)
    r = call("residual", a, x)
    c = call("conv_smooth", r)
    return call("out_norm", call("residual", c, r))


def _zamba2_prefill(call, x):
    d = call("ssm_decay", x)
    u = call("ssm_update", d, x)
    a = call("attn_mix", u)       # the shared attention block
    r = call("residual", a, u)
    f = call("ffn_gate", r)
    return call("out_norm", call("residual", f, r))


def _zamba2_decode(call, x):
    d = call("ssm_decay", x)
    u = call("ssm_update", d, x)
    a = call("attn_mix", u)
    return call("out_norm", call("residual", a, x))


PIPELINES: Dict[str, PipelineSpec] = {
    "transformer": PipelineSpec("transformer", 64,
                                _transformer_prefill, _transformer_decode),
    "moe": PipelineSpec("moe", 64, _moe_prefill, _moe_decode),
    "mamba2": PipelineSpec("mamba2", 48, _mamba2_prefill, _mamba2_decode),
    "whisper": PipelineSpec("whisper", 80, _whisper_prefill, _whisper_decode),
    "zamba2": PipelineSpec("zamba2", 48, _zamba2_prefill, _zamba2_decode),
}

# ArchConfig.family -> serving pipeline (launch.serve uses this to route a
# --arch flag onto the overlay serving path)
FAMILY_PIPELINE = {
    "dense": "transformer",
    "vlm": "transformer",
    "moe": "moe",
    "ssm": "mamba2",
    "hybrid": "zamba2",
    "audio": "whisper",
}


# ------------------------------------------------------------- served model

class ServedModel:
    """One model family instantiated on a Session: a prefill
    :class:`GraphExec` and a decode :class:`GraphExec`, compiled through
    the normal cached/fused pipeline under the model's tenant identity.

    ``max_replicas`` is the replica cap both graphs are built with — the
    lever replica autoscaling turns (:meth:`resize` re-instantiates at a
    new cap; the template cache makes that a ~ms stamp, not a re-anneal).
    ``max_partition_fus`` forces a deeper partition cut, which is how the
    server requests multi-stage (multi-device) pipelines.
    """

    def __init__(self, session: Session, spec: PipelineSpec,
                 max_replicas: int = 2,
                 max_partition_fus: Optional[int] = None,
                 place_effort: float = 0.25):
        self.session = session
        self.spec = spec
        self.name = spec.family
        self.max_replicas = max_replicas
        self.max_partition_fus = max_partition_fus
        self.place_effort = place_effort
        self.prefill_graph = self._capture("prefill", spec.prefill)
        self.decode_graph = self._capture("decode", spec.decode)
        self.prefill_exec: GraphExec = session.instantiate(
            self.prefill_graph, max_partition_fus=max_partition_fus)
        self.decode_exec: GraphExec = session.instantiate(
            self.decode_graph, max_partition_fus=max_partition_fus)

    @property
    def state_dim(self) -> int:
        return self.spec.state_dim

    def _capture(self, which: str, body: Callable) -> KernelGraph:
        opts = CompileOptions(place_effort=self.place_effort,
                              max_replicas=self.max_replicas)

        with self.session.capture(tenant=self.name,
                                  name=f"{self.name}:{which}") as g:
            x = g.input("state")

            def call(kname: str, *bufs):
                fn, n = STAGE_KERNELS[kname]
                return g.call(fn, opts.replace(n_inputs=n, name=kname),
                              *bufs)

            body(call, x)
        return g

    # ------------------------------------------------------------ lifecycle
    def result(self) -> "ServedModel":
        """Block until both graphs' fused builds landed (errors surface
        here, like :meth:`GraphExec.result`)."""
        self.prefill_exec.result()
        self.decode_exec.result()
        return self

    def resize(self, max_replicas: int) -> None:
        """Re-instantiate both graphs at a new replica cap (the autoscaling
        actuator).  The old executions release their fabric first so the
        rebuild can re-pack it; the template tier makes the rebuild a
        stamp, not a fresh anneal."""
        if max_replicas < 1:
            raise ValueError(f"max_replicas must be >= 1, "
                             f"got {max_replicas!r}")
        if max_replicas == self.max_replicas:
            return
        self.prefill_exec.release()
        self.decode_exec.release()
        self.max_replicas = max_replicas
        self.prefill_graph = self._capture("prefill", self.spec.prefill)
        self.decode_graph = self._capture("decode", self.spec.decode)
        self.prefill_exec = self.session.instantiate(
            self.prefill_graph, max_partition_fus=self.max_partition_fus)
        self.decode_exec = self.session.instantiate(
            self.decode_graph, max_partition_fus=self.max_partition_fus)

    def release(self) -> None:
        self.prefill_exec.release()
        self.decode_exec.release()

    def __repr__(self) -> str:
        return (f"ServedModel({self.name}: d={self.state_dim}, "
                f"r<={self.max_replicas}, "
                f"prefill {self.prefill_exec.n_partitions}p / "
                f"decode {self.decode_exec.n_partitions}p)")


def build_zoo(session: Session, families, max_replicas: int = 2,
              max_partition_fus: Optional[int] = None
              ) -> Dict[str, ServedModel]:
    """Instantiate several families on one Session (the server's boot
    path).  Builds overlap on the Session's worker pool — the dict is
    returned as soon as every instantiation is *submitted*."""
    zoo = {}
    for fam in families:
        if fam not in PIPELINES:
            raise KeyError(f"unknown model family {fam!r}; "
                           f"known: {sorted(PIPELINES)}")
        zoo[fam] = ServedModel(session, PIPELINES[fam],
                               max_replicas=max_replicas,
                               max_partition_fus=max_partition_fus)
    return zoo
