"""Parallelism helpers of the port: the GPipe schedule as data and the
pipelined forward over ``torch.distributed`` ranks
(:mod:`repro_torch.parallel.pipeline`)."""
from repro_torch.parallel.pipeline import make_pipeline_train_step  # noqa
