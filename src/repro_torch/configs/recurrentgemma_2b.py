"""RecurrentGemma-2B [arXiv:2402.19427; hf] — Griffin hybrid: RG-LRU
recurrent blocks and local attention in a 2:1 pattern, MQA (kv=1)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma_2b", family="hybrid", num_layers=26, d_model=2560,
    num_heads=10, num_kv_heads=1, d_ff=7680, vocab_size=256000,
    head_dim=256, mlp="swiglu", local_window=2048,
    block_pattern=("rglru", "rglru", "local"),
    source="arXiv:2402.19427; hf",
)
