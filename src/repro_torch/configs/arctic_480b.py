"""Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base; hf] —
MoE 128 experts top-2 with a dense residual MLP path."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic_480b", family="moe", num_layers=35, d_model=7168,
    num_heads=56, num_kv_heads=8, d_ff=4864, vocab_size=32000,
    head_dim=128, mlp="swiglu", num_experts=128, experts_per_token=2,
    moe_dense_residual=True,
    moe_dispatch="batch",   # EXPERIMENTS.md §Perf H1: 7.7x over "global"
    source="hf:Snowflake/snowflake-arctic-base; hf",
)
