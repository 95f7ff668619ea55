"""Config registry of the port: own copies of all ten of the reference's
architectures (dense, moe, hybrid, ssm, vlm and audio), each with
``CONFIG`` (full width) and ``SMOKE`` exactly as in ``repro.configs``, and
of the (arch x shape) cell matrix (``shapes``)."""

from __future__ import annotations

from repro_torch.configs import (codeqwen1_5_7b, granite_3_8b, llama3_405b,
                                llama4_scout_17b_a16e, llama_3_2_vision_11b,
                                mixtral_8x7b, olmo_1b, recurrentgemma_2b,
                                rwkv6_1_6b, whisper_small)
from repro_torch.configs.shapes import SHAPES, ShapeSpec, cells, skip_reason
from repro_torch.models.common import ModelConfig

_MODULES = {
    "granite-3-8b": granite_3_8b,
    "llama3-405b": llama3_405b,
    "codeqwen1.5-7b": codeqwen1_5_7b,
    "olmo-1b": olmo_1b,
    "llama4-scout-17b-a16e": llama4_scout_17b_a16e,
    "mixtral-8x7b": mixtral_8x7b,
    "rwkv6-1.6b": rwkv6_1_6b,
    "llama-3.2-vision-11b": llama_3_2_vision_11b,
    "recurrentgemma-2b": recurrentgemma_2b,
    "whisper-small": whisper_small,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = _MODULES[arch_id]
    return mod.SMOKE if smoke else mod.CONFIG


__all__ = ["ARCH_IDS", "get_config", "SHAPES", "ShapeSpec", "cells",
           "skip_reason", "ModelConfig"]
