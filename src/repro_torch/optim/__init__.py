from repro_torch.optim.adamw import (AdamWConfig, adamw_init,  # noqa: F401
                                     adamw_update, clip_by_global_norm,
                                     lr_schedule)
from repro_torch.optim.compression import (  # noqa: F401
    compress_pytree, decompress_pytree, error_feedback_allreduce)
