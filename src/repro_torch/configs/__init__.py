"""Architecture registry of the port: ``get_config(arch)`` and
``get_reduced(arch)``.  Ported so far: the dense llama3-8b, deepseek-7b,
minicpm-2b, mistral-nemo-12b and qwen2-72b, and the MoE arctic-480b."""

from __future__ import annotations

import importlib

ARCHS = ("minicpm_2b", "deepseek_7b", "mistral_nemo_12b", "qwen2_72b",
         "arctic_480b", "llama3_8b")

# the reference's aliases (``repro.configs``): each name with dashes
_ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def canonical(arch: str) -> str:
    name = _ALIASES.get(arch, arch)
    if name not in ARCHS:
        raise ValueError(f"unknown or unported architecture {arch!r} "
                         f"(ported: {', '.join(ARCHS)})")
    return name


def get_config(arch: str):
    return importlib.import_module(f"repro_torch.configs.{canonical(arch)}"
                                   ).CONFIG


def get_reduced(arch: str):
    return importlib.import_module(f"repro_torch.configs.{canonical(arch)}"
                                   ).reduced()
