"""Architecture registry of the port: ``get_config(arch)`` and
``get_reduced(arch)``.  Ported so far: the dense llama3-8b, deepseek-7b,
minicpm-2b, mistral-nemo-12b and qwen2-72b, the MoE arctic-480b and
kimi-k2-1t-a32b, the hybrid jamba-1.5-large-398b, the pure-SSM
mamba2-1.3b, the VLM llava-next-mistral-7b, the encoder-decoder
seamless-m4t-large-v2 and the DiT backbone pixart-sigma: the reference's
whole registry."""

from __future__ import annotations

import importlib

ARCHS = ("minicpm_2b", "deepseek_7b", "mistral_nemo_12b", "qwen2_72b",
         "llava_next_mistral_7b", "jamba_1_5_large_398b",
         "seamless_m4t_large_v2", "kimi_k2_1t_a32b", "arctic_480b",
         "mamba2_1_3b", "llama3_8b", "pixart_sigma")

# the reference's aliases (``repro.configs``): each name with dashes, and
# the dotted versions' names
_ALIASES = {a.replace("_", "-"): a for a in ARCHS}
_ALIASES.update({"jamba-1.5-large-398b": "jamba_1_5_large_398b",
                 "mamba2-1.3b": "mamba2_1_3b"})


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
