"""Qwen2-0.5B [arXiv:2407.10671; hf] — dense, GQA kv=2, QKV bias."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2_05b", family="dense", num_layers=24, d_model=896,
    num_heads=14, num_kv_heads=2, d_ff=4864, vocab_size=151936,
    head_dim=64, qkv_bias=True, mlp="swiglu",
    source="arXiv:2407.10671; hf",
)
