from repro_torch.models.common import ArchConfig  # noqa: F401
from repro_torch.models.registry import build_model, get_config  # noqa: F401
