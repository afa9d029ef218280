"""Architecture / shape registry and dry-run cell enumeration."""
from __future__ import annotations

import importlib
from typing import Iterator, List, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig, SHAPES, SHAPES_BY_NAME

# arch-id -> module name
ARCH_MODULES = {
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "internvl2-1b": "internvl2_1b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "smollm-135m": "smollm_135m",
    "granite-3-2b": "granite_3_2b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "yi-6b": "yi_6b",
    "mamba2-370m": "mamba2_370m",
    "zamba2-7b": "zamba2_7b",
}

ARCHS: List[str] = list(ARCH_MODULES)

#: configurations beyond the JAX package's (``ARCHS`` equals its list):
#: ``get_config`` resolves them, the dry run's cells do not enumerate them
EXTRA_MODULES = {
    "zamba2-7b-instruct": "zamba2_7b_instruct",
}

# Archs with sub-quadratic sequence mixing; only these run ``long_500k``
# (pure full-attention archs skip it — see DESIGN.md §Arch-applicability).
SUBQUADRATIC = {"mamba2-370m", "zamba2-7b"}


def get_config(arch: str) -> ModelConfig:
    modules = {**ARCH_MODULES, **EXTRA_MODULES}
    if arch not in modules:
        raise KeyError(f"unknown arch {arch!r}; known: {list(modules)}")
    mod = importlib.import_module(f"repro_torch.configs.{modules[arch]}")
    return mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES_BY_NAME[name]


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """Skip rules for (arch x shape) cells."""
    if shape.name == "long_500k":
        return cfg.name in SUBQUADRATIC
    # No encoder-only archs in the pool; all archs have a decode step.
    return True


def cells() -> Iterator[Tuple[str, str]]:
    """All applicable (arch, shape) dry-run cells."""
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES:
            if shape_applicable(cfg, shape):
                yield arch, shape.name
