"""Architecture registry of the port: ``get_config(arch)`` and
``get_reduced(arch)``.  Ported so far: the dense llama3-8b and the MoE
arctic-480b."""

from __future__ import annotations

import importlib

ARCHS = ("llama3_8b", "arctic_480b")

_ALIASES = {"llama3-8b": "llama3_8b", "arctic-480b": "arctic_480b"}


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
