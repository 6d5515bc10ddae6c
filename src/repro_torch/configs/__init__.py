from repro_torch.configs.base import (SHAPES, SHAPES_BY_NAME, ModelConfig,
                                      ShapeConfig, shape_applicable)
from repro_torch.configs.registry import ARCH_IDS, get_config, get_reduced

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "SHAPES_BY_NAME",
           "shape_applicable", "ARCH_IDS", "get_config", "get_reduced"]
