"""Model / shape configuration system.

Every assigned architecture has a module in this package exposing
``CONFIG: ModelConfig``.  ``get_config(name)`` resolves by id; every config
also provides ``.reduced()`` — a small same-family variant used by CPU
smoke tests (full configs are traced on ``meta`` tensors).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    mlp: str = "swiglu"              # swiglu | gelu
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_dense_residual: bool = False     # arctic: MoE + dense residual path
    moe_capacity_factor: float = 1.25
    # "global": route over all B*S tokens (one pool; reshape merges the
    # batch dim and breaks its sharding color).  "batch": route per batch
    # row (DP-local routing — keeps the batch color sharded; see
    # EXPERIMENTS.md §Perf iteration 1).
    moe_dispatch: str = "global"
    moe_local_pools: int = 16        # seq pools for "local" dispatch
    # --- attention variants ---
    sliding_window: int = 0              # mixtral SWA (0 = full)
    local_window: int = 0                # recurrentgemma local attention
    block_pattern: tuple[str, ...] = ()  # per-layer kinds, tiled to num_layers
    rope_theta: float = 10000.0
    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    is_encoder_decoder: bool = False
    # --- modality frontend stubs ---
    frontend: Optional[str] = None       # "vision" | "audio"
    num_patches: int = 576               # vlm: CLIP 24x24 patch embeddings
    # --- numerics / memory ---
    param_dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"       # "full" | "dots" (save dot outputs)
    # shard logits on the vocab color instead of seq (the [B,S,V] logits
    # tensor can carry "model" on only one dim; vocab wins for large-vocab
    # models — see EXPERIMENTS.md §Perf iteration 2)
    logits_vocab_shard: bool = False
    # which side of the attention-score sequence conflict to shard
    # (the paper's resolution_order, exposed per-model): "q" or "kv"
    score_shard_dim: str = "q"
    # route attention / recurrence layers through the fused Pallas
    # kernels (repro.kernels.ops).  The tracer records those calls as
    # single fused IR ops, so flipping this changes the analyzed
    # program (and its fingerprint) — off by default.
    use_pallas: bool = False
    # source provenance tag from the assignment table
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def pattern(self) -> tuple[str, ...]:
        """Per-layer block kinds, length == num_layers."""
        if not self.block_pattern:
            return ("attn",) * self.num_layers
        reps = -(-self.num_layers // len(self.block_pattern))
        return (self.block_pattern * reps)[: self.num_layers]

    @property
    def dtype(self):
        return getattr(torch, self.param_dtype)

    @property
    def sub_quadratic(self) -> bool:
        """True when no layer needs a full seq×seq score matrix."""
        kinds = set(self.pattern)
        if "attn" in kinds and self.sliding_window == 0:
            return False
        return True

    def num_params(self) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        h, kv, hd = self.num_heads, self.num_kv_heads, self.resolved_head_dim
        total = v * d                                   # embed
        for kind in self.pattern:
            if kind == "attn":
                total += d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d
                if self.num_experts:
                    total += self.num_experts * 3 * d * f
                    if self.moe_dense_residual:
                        total += 3 * d * f
                else:
                    total += (3 if self.mlp == "swiglu" else 2) * d * f
            elif kind == "rglru":
                total += 2 * d * (d * 3 // 2) + 4 * (d * 3 // 2)
                total += 3 * d * f
            elif kind in ("mlstm", "slstm"):
                total += 4 * d * d + 2 * d * 2 * d
        total += v * d                                  # unembed
        if self.is_encoder_decoder:
            total *= 2
        return total

    def reduced(self) -> "ModelConfig":
        """Small same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=max(2, min(4, len(self.block_pattern) or 2)),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) or 2,
            d_ff=0 if self.d_ff == 0 else 128,
            vocab_size=256,
            head_dim=16,
            num_experts=min(self.num_experts, 4),
            moe_capacity_factor=4.0,     # no token drops in smoke tests
            sliding_window=min(self.sliding_window, 16) if
            self.sliding_window else 0,
            local_window=min(self.local_window, 16) if
            self.local_window else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            num_patches=8,
            param_dtype="float32",
            remat=False,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "qwen15_32b", "qwen2_05b", "llama3_405b", "phi3_mini", "phi3_vision",
    "whisper_small", "arctic_480b", "mixtral_8x22b", "recurrentgemma_2b",
    "xlstm_350m",
]


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{name.replace('-', '_')}")
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def cells(arch: str) -> list[ShapeConfig]:
    """The (shape) cells defined for an arch, observing the long_500k and
    decode skip rules from the assignment."""
    cfg = get_config(arch)
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.sub_quadratic:
        out.append(SHAPES["long_500k"])
    return out
