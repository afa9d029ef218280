from repro_torch.configs.base import ModelConfig, ShapeConfig, SHAPES, SHAPES_BY_NAME
from repro_torch.configs.registry import (
    ARCHS,
    SUBQUADRATIC,
    cells,
    get_config,
    get_shape,
    shape_applicable,
)

__all__ = [
    "ModelConfig",
    "ShapeConfig",
    "SHAPES",
    "SHAPES_BY_NAME",
    "ARCHS",
    "SUBQUADRATIC",
    "cells",
    "get_config",
    "get_shape",
    "shape_applicable",
]
