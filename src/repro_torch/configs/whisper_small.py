"""Whisper-small [arXiv:2212.04356; unverified] — enc-dec transformer
backbone; conv audio frontend is a stub (input_specs provides precomputed
frame embeddings)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper_small", family="audio", num_layers=12, d_model=768,
    num_heads=12, num_kv_heads=12, d_ff=3072, vocab_size=51865,
    head_dim=64, mlp="gelu", encoder_layers=12, is_encoder_decoder=True,
    frontend="audio",
    source="arXiv:2212.04356; unverified",
)
