"""``repro_torch.obs`` — tracing, metrics and profile-guided re-cutting.

The observability layer for the overlay JIT runtime:

* :mod:`repro_torch.obs.trace` — ambient span tracer (the ``faults.py``
  thread-local pattern: the disabled path is one TLS read);
* :mod:`repro_torch.obs.metrics` — counters / gauges / histograms
  pluggable into ``Session.register_stats_section``;
* :mod:`repro_torch.obs.export` — Chrome-trace (Perfetto) JSON exporter;
* :mod:`repro_torch.obs.profile` — content-addressed replay profiles
  persisted through the disk/remote cache tiers;
* :mod:`repro_torch.obs.recut` — profile-guided graph re-cutter
  (never-worse swap through the warm single-flight compile path);
* ``python -m repro_torch.obs`` — trace a demo pipeline on the card and
  export the JSON.

Spans, profiles and the export hold the queues' modelled µs (and the
host's wall clock for host spans), as in the JAX package; no time here is
read from the card.

``profile``/``recut`` are imported lazily: they depend on
``repro_torch.core``, and the core runtime imports
``repro_torch.obs.trace`` for its probe points — eager imports here would
make that circular.
"""

from repro_torch.obs.export import (chrome_trace, render_summary,
                                    write_chrome_trace)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry)
from repro_torch.obs.trace import (CATEGORIES, Span, Tracer, activate,
                                   active_tracer, modelled, span)

__all__ = [
    "CATEGORIES", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "PartitionProfile", "ProfileStore", "ReCutResult", "ReCutter",
    "ReplayProfile", "Span", "Tracer", "activate", "active_tracer",
    "chrome_trace", "estimate_cut_us", "hot_profiles", "modelled",
    "plan_recut", "profile_key", "render_summary", "span",
    "write_chrome_trace",
]

_LAZY = {
    "PartitionProfile": "repro_torch.obs.profile",
    "ProfileStore": "repro_torch.obs.profile",
    "ReplayProfile": "repro_torch.obs.profile",
    "hot_profiles": "repro_torch.obs.profile",
    "profile_key": "repro_torch.obs.profile",
    "ReCutResult": "repro_torch.obs.recut",
    "ReCutter": "repro_torch.obs.recut",
    "estimate_cut_us": "repro_torch.obs.recut",
    "plan_recut": "repro_torch.obs.recut",
}


def __getattr__(name):
    modname = _LAZY.get(name)
    if modname is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib
    return getattr(importlib.import_module(modname), name)


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
