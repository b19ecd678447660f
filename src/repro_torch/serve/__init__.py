"""repro_torch.serve — continuous-batching inference over the Session API.

The model zoo's layer pipelines as captured kernel graphs
(:mod:`~repro_torch.serve.models`), an ORCA-style iteration-level
batching server with SLO classes and replica autoscaling hints
(:mod:`~repro_torch.serve.server`), and GPipe-wavefront stage parallelism
for partitioned replays (:mod:`~repro_torch.serve.stagepar` — imported
lazily, as in the JAX package).  Every served iteration runs the overlay
executor on states kept on the Session's device; see ``docs/serving.md``
for the serving model.
"""

from repro_torch.serve.batcher import ModelBatch
from repro_torch.serve.models import (FAMILY_PIPELINE, PIPELINES,
                                      STAGE_KERNELS, PipelineSpec,
                                      ServedModel, build_zoo)
from repro_torch.serve.request import (DECODING, DONE, PREFILLING, QUEUED,
                                       REJECTED, Request)
from repro_torch.serve.server import (InferenceServer, serve_sequential)
from repro_torch.serve.slo import (BATCH, REALTIME, SLO_CLASSES, STANDARD,
                                   SLOClass, get_slo)

__all__ = [
    "BATCH", "DECODING", "DONE", "FAMILY_PIPELINE", "InferenceServer",
    "ModelBatch", "PIPELINES", "PREFILLING", "PipelineSpec", "QUEUED",
    "REALTIME", "REJECTED", "Request", "SLOClass", "SLO_CLASSES",
    "STAGE_KERNELS", "STANDARD", "ServedModel", "build_zoo", "get_slo",
    "serve_sequential",
]
