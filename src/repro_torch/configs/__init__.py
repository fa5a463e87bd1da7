"""Architecture registry: the 10 assigned configs and the paper's GPT-2,
the reference's eleven (``src/repro/configs``)."""
from . import (arctic_480b, command_r_plus_104b, glm4_9b, gpt2_paper,
               jamba_v0_1_52b, llava_next_mistral_7b, mamba2_1_3b,
               musicgen_medium, qwen2_moe_a2_7b, smollm_360m, stablelm_1_6b)
from .base import SHAPES, ModelConfig, ShapeConfig, input_specs, shape_applicable

_MODULES = {
    "arctic-480b": arctic_480b,
    "qwen2-moe-a2.7b": qwen2_moe_a2_7b,
    "mamba2-1.3b": mamba2_1_3b,
    "command-r-plus-104b": command_r_plus_104b,
    "stablelm-1.6b": stablelm_1_6b,
    "smollm-360m": smollm_360m,
    "glm4-9b": glm4_9b,
    "llava-next-mistral-7b": llava_next_mistral_7b,
    "musicgen-medium": musicgen_medium,
    "jamba-v0.1-52b": jamba_v0_1_52b,
    "gpt2-paper": gpt2_paper,
}

ARCHS = tuple(k for k in _MODULES if k != "gpt2-paper")


def get_config(name: str) -> ModelConfig:
    return _MODULES[name].CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _MODULES[name].SMOKE


__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeConfig", "get_config",
           "get_smoke", "input_specs", "shape_applicable"]
