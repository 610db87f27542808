"""Model configuration of the port (the ``ModelConfig`` dataclass)."""
from repro_torch.configs.base import ModelConfig  # noqa: F401
