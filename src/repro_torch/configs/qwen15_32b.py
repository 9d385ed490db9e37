"""Qwen1.5-32B [hf:Qwen/Qwen1.5-0.5B family; hf] — dense, QKV bias."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen15_32b", family="dense", num_layers=64, d_model=5120,
    num_heads=40, num_kv_heads=40, d_ff=27392, vocab_size=152064,
    head_dim=128, qkv_bias=True, mlp="swiglu",
    source="hf:Qwen/Qwen1.5-0.5B; hf",
)
