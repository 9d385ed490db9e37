"""xLSTM-350M [arXiv:2405.04517; unverified] — sLSTM + mLSTM blocks in the
paper's 7:1 ratio; no separate MLP (d_ff=0)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm_350m", family="ssm", num_layers=24, d_model=1024,
    num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=50304,
    head_dim=256,
    block_pattern=("mlstm", "mlstm", "mlstm", "mlstm",
                   "mlstm", "mlstm", "mlstm", "slstm"),
    source="arXiv:2405.04517; unverified",
)
