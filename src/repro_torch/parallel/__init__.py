"""Parallelism helpers of the port: the GPipe schedule as data
(:mod:`repro_torch.parallel.pipeline`)."""
