"""Serving step factories.

``make_prefill_step`` builds the prefill entry point: the full-sequence
forward, returning the last position's logits; ``make_decode_step`` the
one-token decode step over the KV / recurrent caches.  The train step
and the optimizer are ROADMAP queue 1, item 4.
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


def make_decode_step(cfg):
    """``decode(params, cache, token, pos) -> (logits, new cache)``.

    Args:
        cfg: the model configuration.

    Returns:
        The decode step: ``token`` is ``(B, 1)`` int, ``pos`` a 0-d int32
        tensor, the cache as ``transformer.init_cache`` builds it;
        ``logits`` is ``(B, 1, vocab)``.
    """
    def decode(params, cache, token, pos):
        return T.decode_step(cfg, params, cache, token, pos)
    return decode
