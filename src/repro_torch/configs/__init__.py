from repro_torch.configs.base import (
    SHAPES,
    EncDecConfig,
    Family,
    FrontendConfig,
    HybridConfig,
    MambaConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    OverlapConfig,
    ShapeConfig,
    XLSTMConfig,
)
from repro_torch.configs.registry import ARCHS, get_config

__all__ = [
    "SHAPES", "ARCHS", "get_config",
    "EncDecConfig", "Family", "FrontendConfig", "HybridConfig",
    "MambaConfig", "MLAConfig", "ModelConfig", "MoEConfig",
    "OverlapConfig", "ShapeConfig", "XLSTMConfig",
]
