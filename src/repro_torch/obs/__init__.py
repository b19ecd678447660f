"""Observability: the ambient span tracer (:mod:`repro_torch.obs.trace`).

The metrics registry, exporters and profile store follow with the runtime.
"""
