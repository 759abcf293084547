"""SeamlessM4T-Large-v2 [arXiv:2308.11596; hf] — encoder-decoder,
multimodal.  The speech frontend is a stub: a batch carries pre-computed
frame embeddings (b, seq / frame_ratio, d_model) (``frames``), which the
encoder reads; every decoder layer cross-attends to its output."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=8192, vocab_size=256206,
    encoder_layers=24, frontend="frames", frame_ratio=4,
    source="arXiv:2308.11596; hf",
)


def reduced():
    return dataclasses.replace(
        CONFIG, num_layers=2, encoder_layers=2, d_model=128, num_heads=4,
        num_kv_heads=4, d_ff=256, vocab_size=512)
