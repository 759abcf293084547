"""LLaVA-NeXT (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf;
unverified] — VLM: the anyres patch tiling is a frontend stub; a batch
carries pre-computed merged patch embeddings at d_model (``patches``),
which the model puts before the prompt's token embeddings."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=32000,
    frontend="patch", num_patches=576,
    rope_theta=1e6,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
)


def reduced():
    return dataclasses.replace(
        CONFIG, num_layers=3, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=384, vocab_size=512, num_patches=16)
