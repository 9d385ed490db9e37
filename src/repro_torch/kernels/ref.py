"""Plain PyTorch versions of the fused kernels (the allclose references)."""

from __future__ import annotations

import math

import torch


def reference_attention(q, k, v, *, causal: bool = True,
                        sm_scale: float | None = None):
    """Attention, plainly: q (B,H,S,hd); k, v (B,H,T,hd) -> (B,H,S,hd).

    Scores are taken in float32 and masked (``q_pos >= k_pos`` on
    absolute positions) with ``-1e30``; probabilities are cast to
    ``v.dtype`` before the PV product.  This is the plain version of
    the CUDA flash-attention kernel (``kernels/flash_attention.py``).
    """
    hd = q.shape[-1]
    sm_scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(hd)
    s = torch.einsum("bhsd,bhtd->bhst", q, k).to(torch.float32) * sm_scale
    if causal:
        S, T = s.shape[-2:]
        pos_q = torch.arange(S, device=s.device)[:, None]
        pos_k = torch.arange(T, device=s.device)[None, :]
        s = torch.where(pos_q >= pos_k, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p.to(v.dtype), v)
