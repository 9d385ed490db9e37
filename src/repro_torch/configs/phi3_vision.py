"""Phi-3-vision 4.2B [hf:microsoft/Phi-3-vision-128k-instruct; hf] —
phi3-mini backbone + CLIP patch-embedding frontend (stub per assignment)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3_vision", family="vlm", num_layers=32, d_model=3072,
    num_heads=32, num_kv_heads=32, d_ff=8192, vocab_size=32064,
    head_dim=96, mlp="swiglu", frontend="vision", num_patches=576,
    source="hf:microsoft/Phi-3-vision-128k-instruct; hf",
)
