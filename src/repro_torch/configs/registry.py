"""--arch registry of the port: maps architecture ids to their (full,
smoke) ModelConfigs.

The port runs all ten of the reference's archs; ``NOT_PORTED`` is empty
(an arch listed there would raise ``NotImplementedError`` naming
ROADMAP.md, where its slice is queued).
"""
from __future__ import annotations

import importlib
from typing import Tuple

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig

ARCH_IDS = (
    "llama3-8b",
    "granite-8b",
    "starcoder2-3b",
    "gemma3-27b",
    "qwen2-vl-2b",
    "recurrentgemma-2b",
    "whisper-medium",
    "mamba2-370m",
    "granite-moe-3b-a800m",
    "llama4-maverick-400b-a17b",
)

#: reference archs whose port is still queued in ROADMAP.md
NOT_PORTED: tuple = ()


def _module(arch: str):
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to repro_torch yet; see the "
            f"queue in ROADMAP.md")
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; ported: {ARCH_IDS}")
    return importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_')}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Assignment rules: which (arch × shape) cells run.

    * long_500k only for sub-quadratic archs,
    * decode shapes skipped for encoder-only archs (none assigned).
    """
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "dense-attention arch: 512k decode is out of scope"
    return True, ""


def all_cells():
    """All (arch, shape) cells with applicability flags."""
    out = []
    for a in ARCH_IDS:
        cfg = get_config(a)
        for s in SHAPES.values():
            ok, why = shape_applicable(cfg, s)
            out.append((a, s.name, ok, why))
    return out
