"""Serving step factories.

``make_prefill_step`` builds the prefill entry point: the full-sequence
forward, returning the last position's logits.  The train step, the
optimizer and the decode step are ROADMAP queue 1, items 4 and 12.
"""

from __future__ import annotations

from repro_torch.models import transformer as T


def make_prefill_step(cfg):
    """``prefill(params, batch) -> (B, vocab)`` next-token logits.

    Args:
        cfg: the model configuration.

    Returns:
        The prefill step; ``batch["tokens"]`` is a ``(B, S)`` int tensor.
    """
    def prefill(params, batch):
        logits = T.forward(cfg, params, batch["tokens"])
        return logits[:, -1]
    return prefill
