"""Architecture registry. This slice ports the paper's GPT-2; the other
architectures of ``src/repro/configs`` wait for ROADMAP A21."""
from . import gpt2_paper
from .base import ModelConfig

_MODULES = {"gpt2-paper": gpt2_paper}

_NOT_PORTED = ("arctic-480b", "qwen2-moe-a2.7b", "mamba2-1.3b",
               "command-r-plus-104b", "stablelm-1.6b", "smollm-360m",
               "glm4-9b", "llava-next-mistral-7b", "musicgen-medium",
               "jamba-v0.1-52b")


def _module(name: str):
    if name in _MODULES:
        return _MODULES[name]
    if name in _NOT_PORTED:
        raise NotImplementedError(f"architecture {name!r} is not ported "
                                  "yet: ROADMAP A21")
    raise KeyError(f"unknown architecture {name!r}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE


__all__ = ["ModelConfig", "get_config", "get_smoke"]
