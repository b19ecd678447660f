"""Compile options — ONE frozen, hashable object instead of a knob soup.

Every tunable the JIT pipeline accepts used to travel as loose keyword
arguments (``jit_compile(source, spec, max_replicas=..., seed=...,
place_effort=..., pr_mode=..., min_template_fill=..., ...)``) and was
re-assembled into an ad-hoc tuple inside ``make_cache_key``.  The Session
API collapses them into :class:`CompileOptions`:

  * it is **frozen** (hashable, comparable) — a CompileOptions value can key
    a dict, deduplicate in-flight builds (the Session's single-flight map),
    and be stored on a Program for later rebuilds (shed / re-inflate);
  * it **is the cache-key tail**: :meth:`CompileOptions.key_tail` is the
    canonical serialization hashed into the compile-cache key, so "what can
    change the produced artifact" and "what the API accepts" are the same
    object by construction;
  * validation happens once, at construction, instead of at the top of
    every entry point.

``n_inputs``/``name`` describe the *kernel* (how to trace a python
callable), not the build — they ride along for convenience but are
deliberately excluded from :meth:`key_tail` (the DFG fingerprint already
covers kernel identity, and names never key anything).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# auto mode accepts the template path when it reaches this fraction of the
# planned replica count (1.0 restores exact-parity-or-fallback semantics);
# below it the joint annealer runs and the better artifact wins
DEFAULT_MIN_TEMPLATE_FILL = 0.95

_PR_MODES = ("auto", "template", "joint")

_VERIFY_LEVELS = ("off", "fused", "full")


@dataclasses.dataclass(frozen=True)
class CompileOptions:
    """Everything a caller can turn on the JIT pipeline, in one value.

    Fields mirror the historical ``jit_compile`` keywords exactly, so the
    migration is mechanical (see ROADMAP "Runtime v2" migration table).
    """
    n_inputs: Optional[int] = None       # arity when tracing a python callable
    name: Optional[str] = None           # kernel display name (never keyed)
    max_replicas: Optional[int] = None   # cap on resource-aware replication
    seed: int = 0                        # placement RNG seed
    place_effort: float = 1.0            # annealer effort multiplier
    pr_mode: str = "auto"                # auto | template | joint
    min_template_fill: float = DEFAULT_MIN_TEMPLATE_FILL
    # graph-instantiation knob: cap on the FUs a fused partition may pack
    # (None = whatever fits the roomiest device with one replica).  Like
    # max_replicas it never changes a single compiled artifact — only how a
    # recorded KernelGraph is cut into partitions — so it is excluded from
    # key_tail(); a different cut reaches the cache as a different fused DFG
    max_partition_fus: Optional[int] = None
    # static-analysis gate (repro_torch.analysis): "off" = build as before;
    # "fused" = run the A0xx semantic checks on the DFG being compiled;
    # "full" = additionally re-prove every artifact's legality (A2xx) —
    # fresh builds before they enter the cache, cache hits before they are
    # returned (failed hits are quarantined like corrupt DiskCache
    # entries).  Verification never changes the artifact, so it is
    # excluded from key_tail(): verified and unverified builds share cache
    # entries.
    verify_level: str = "off"
    # self-healing knobs (repro_torch.core.recovery): how many transient build
    # failures (injected faults, device loss, I/O errors) the Session may
    # absorb before the exception reaches the KernelFuture (None = the
    # session RetryPolicy's default), and a wall-clock compile deadline
    # after which a hedged rebuild at lower place_effort races the
    # straggler.  Neither changes the produced artifact — a build that
    # succeeds after 3 retries is bit-identical to one that succeeds first
    # try — so both are excluded from key_tail() like verify_level.
    retry_budget: Optional[int] = None
    deadline_ms: Optional[float] = None

    def __post_init__(self) -> None:
        if self.verify_level not in _VERIFY_LEVELS:
            raise ValueError(f"verify_level must be off|fused|full, "
                             f"got {self.verify_level!r}")
        if self.pr_mode not in _PR_MODES:
            raise ValueError(f"pr_mode must be auto|template|joint, "
                             f"got {self.pr_mode!r}")
        if not 0.0 < self.min_template_fill <= 1.0:
            raise ValueError(f"min_template_fill must be in (0, 1], "
                             f"got {self.min_template_fill!r}")
        if self.max_partition_fus is not None and self.max_partition_fus < 1:
            raise ValueError(f"max_partition_fus must be >= 1, "
                             f"got {self.max_partition_fus!r}")
        if self.retry_budget is not None and self.retry_budget < 0:
            raise ValueError(f"retry_budget must be >= 0, "
                             f"got {self.retry_budget!r}")
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, "
                             f"got {self.deadline_ms!r}")

    # ---------------------------------------------------------------- keying
    def key_tail(self) -> str:
        """Canonical serialization of every artifact-changing knob.

        ``max_replicas`` is absent on purpose: the cache key normalizes the
        free-resource snapshot *and* the cap through the replication plan
        they jointly imply (see :func:`repro_torch.core.cache.make_cache_key`), so
        the plan — not the raw cap — is what gets hashed.
        ``max_partition_fus`` is absent too: it only steers how a recorded
        graph is partitioned, and a different partitioning reaches the cache
        as a different fused-DFG fingerprint.  ``verify_level`` is absent
        because verification never changes the artifact — a kernel built
        under ``"full"`` is byte-identical to one built under ``"off"``,
        so both must hit the same cache entry.  ``retry_budget`` and
        ``deadline_ms`` are absent for the same reason: they steer *when a
        build gives up*, never what it produces, and a kernel that needed a
        retry must still warm the cache for callers with no retry budget.
        The format matches the pre-Session ad-hoc tuple byte for byte, so
        existing disk-cache tiers stay warm across the API migration."""
        return (f"{self.seed}:{self.place_effort:g}:{self.pr_mode}:"
                f"{self.min_template_fill:g}")

    def replace(self, **changes) -> "CompileOptions":
        """A copy with ``changes`` applied (frozen dataclasses can't mutate;
        the scheduler uses this to re-target ``max_replicas`` on resize)."""
        return dataclasses.replace(self, **changes)

    # ---------------------------------------------------------------- fusion
    def fuse_compatible(self, other: "CompileOptions") -> bool:
        """Whether two recorded graph calls may share one fused partition.

        Kernel descriptors (``n_inputs``/``name``) and the partition-level
        caps (``max_replicas`` — min-merged across the partition — and
        ``max_partition_fus``) never block fusion; every knob that changes
        the compiled artifact (exactly :meth:`key_tail`) must agree, or the
        two nodes need separate configurations anyway."""
        return self.key_tail() == other.key_tail()
