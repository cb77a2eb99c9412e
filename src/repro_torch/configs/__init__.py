"""Architecture config registry: ``get_config("<arch-id>")``.

The port of ``repro/configs``: the same configurations, shapes only, with
``torch`` dtypes.

One module per assigned architecture (exact public-literature configs), plus
``grasorw`` — the paper's own graph-task configuration.  Shape sets are in
:data:`SHAPES`; applicability rules (long_500k only for sub-quadratic archs,
decode only for archs with a decoder) are encoded on the config.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.models.common import ModelConfig

from . import (
    deepseek_v2_236b,
    internvl2_1b,
    llama32_1b,
    mamba2_27b,
    mixtral_8x22b,
    phi3_mini_38b,
    qwen15_05b,
    recurrentgemma_2b,
    whisper_tiny,
    yi_34b,
)

_MODULES = {
    "recurrentgemma-2b": recurrentgemma_2b,
    "qwen1.5-0.5b": qwen15_05b,
    "llama3.2-1b": llama32_1b,
    "phi3-mini-3.8b": phi3_mini_38b,
    "yi-34b": yi_34b,
    "whisper-tiny": whisper_tiny,
    "mamba2-2.7b": mamba2_27b,
    "mixtral-8x22b": mixtral_8x22b,
    "deepseek-v2-236b": deepseek_v2_236b,
    "internvl2-1b": internvl2_1b,
}

ARCH_IDS: List[str] = list(_MODULES)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def get_config(arch_id: str) -> ModelConfig:
    try:
        return _MODULES[arch_id].config()
    except KeyError:
        raise ValueError(f"unknown arch {arch_id!r}; have {ARCH_IDS}")


def reduced_config(arch_id: str) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    return _MODULES[arch_id].reduced()


def shape_applicable(cfg: ModelConfig, shape: str) -> bool:
    spec = SHAPES[shape]
    if spec.kind == "decode" and cfg.skip_decode:
        return False
    if spec.name == "long_500k" and not cfg.subquadratic:
        return False
    return True
