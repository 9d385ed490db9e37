"""Llama-3 405B [arXiv:2407.21783; unverified] — dense, GQA kv=8, 128k vocab."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3_405b", family="dense", num_layers=126, d_model=16384,
    num_heads=128, num_kv_heads=8, d_ff=53248, vocab_size=128256,
    head_dim=128, mlp="swiglu", rope_theta=500000.0,
    source="arXiv:2407.21783; unverified",
)
