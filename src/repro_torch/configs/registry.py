"""Architecture + input-shape registry."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ModelConfig

_ARCHS = {
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
    "yi-9b": "repro_torch.configs.yi_9b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "whisper-small": "repro_torch.configs.whisper_small",
    "gemma2-9b": "repro_torch.configs.gemma2_9b",
    "llama-3.2-vision-90b": "repro_torch.configs.llama_3_2_vision_90b",
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
}


def list_configs() -> list[str]:
    return sorted(_ARCHS)


def get_config(name: str) -> ModelConfig:
    if name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; options: {list_configs()}")
    return importlib.import_module(_ARCHS[name]).CONFIG


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) — DESIGN.md §5 skip rules."""
    if shape.name == "long_500k" and cfg.family == "audio":
        return False, "enc-dec audio: source caps decoder positions at 448"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention decoder: 524288-token dense KV is "
                       "quadratic-history; no SWA variant claimed by source")
    return True, ""
