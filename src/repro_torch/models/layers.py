"""Model building blocks in PyTorch: the dense decoder's and the hybrid's
parts.

Ported so far: RMSNorm, RoPE, GQA attention (full, sliding-window and
non-causal masking; the einsum path and the fused-kernel path; the
one-token decode form over a ring-buffer KV cache), the SwiGLU MLP and
the Griffin RG-LRU block (full sequence, on the associative-scan path
or the fused-kernel path; the one-token decode form over its recurrent
and conv state).  The other block kinds of the reference (MoE, xLSTM,
cross-attention, the GELU MLP) are ROADMAP queue 1, items 10-11.

Functions take plain tensors and parameter dicts in the reference's
pytree layout.  They are written as the same reduce / elementwise steps
the reference lowers to (the means, the softmax, the GQA repeat, GELU's
and softplus's formulas, the associative scan), so the traced program
gives NDA the same structure.  Activations are
annotated with logical dim names via ``sharding.constrain``.
"""

from __future__ import annotations

import math
import struct

import numpy as np
import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import lru_associative_scan
from repro_torch.models.sharding import (constrain, einsum, index_copy,
                                        matmul, pointwise, replicate_like,
                                        split_dim)

# ---------------------------------------------------------------------------
# common
# ---------------------------------------------------------------------------


def dense_fan_in(shape) -> int:
    """Fan-in of a dense weight (its contracted dim)."""
    return shape[-2] if len(shape) >= 2 else shape[-1]


def round_to(dtype, x: float) -> float:
    """``x`` rounded to nearest-even in ``dtype`` (host arithmetic)."""
    if dtype == torch.bfloat16:
        bits = struct.unpack("<I", struct.pack("<f", x))[0]
        bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
        return struct.unpack("<f", struct.pack("<I", bits))[0]
    if dtype == torch.float16:
        return float(np.float16(x))
    return float(np.float32(x)) if dtype == torch.float32 else x


def rmsnorm(x, scale, eps=1e-6):
    x32 = x.to(torch.float32)
    var = (x32 * x32).sum(-1, keepdim=True) / x.shape[-1]
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope(x, positions, theta):
    """x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = replicate_like(
        torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                device=x.device) * (math.log(theta) / half)),
        positions)
    ang = positions[..., None].to(torch.float32) * freqs   # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def softmax(x):
    """Softmax over the last dim, as max-shifted exp over its sum.

    The shift is detached, as the reference stops its gradient: it
    cancels in the result, so no gradient flows through the max.
    """
    e = torch.exp(x - x.amax(-1, keepdim=True).detach())
    return e / e.sum(-1, keepdim=True)


def repeat_heads(x, g: int):
    """(B, T, KV, hd) -> (B, T, KV*g, hd), each head repeated ``g`` times."""
    B, T, KV, hd = x.shape
    return x[:, :, :, None, :].expand(B, T, KV, g, hd).reshape(
        B, T, KV * g, hd)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def attn_param_shapes(cfg) -> dict:
    """Shapes and init kinds of one attention block's parameters."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    p = {"ln": ((d,), "ones"), "wq": ((d, h * hd), "dense"),
         "wk": ((d, kv * hd), "dense"), "wv": ((d, kv * hd), "dense"),
         "wo": ((h * hd, d), "dense")}
    if cfg.qkv_bias:
        p["bq"] = ((h * hd,), "zeros")
        p["bk"] = ((kv * hd,), "zeros")
        p["bv"] = ((kv * hd,), "zeros")
    return p


def _project_qkv(cfg, p, x, positions, kv_positions=None):
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = matmul(x, p["wq"])
    k = matmul(x, p["wk"])
    v = matmul(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if kv_positions is None:
        kv_positions = positions
    q = rope(split_dim(q, -1, (h, hd)), positions, cfg.rope_theta)
    k = rope(split_dim(k, -1, (kv, hd)), kv_positions, cfg.rope_theta)
    return q, k, split_dim(v, -1, (kv, hd))


def attn_core(cfg, q, k, v, mask):
    """GQA attention. q: (B,S,H,hd); k,v: (B,T,KV,hd); mask: (B,S,T) or
    (S,T) bool, or None."""
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    g = h // kv
    B, S = q.shape[0], q.shape[1]
    qg = split_dim(q, 2, (kv, g))
    scores = einsum("bskgh,btkh->bkgst", qg, k).to(torch.float32)
    scores = scores / math.sqrt(hd)
    scores = constrain(scores, ("act_batch", "kv_heads", None, "seq", None))
    if mask is not None:
        # one broadcast, as the reference's mask[:, None, None] or
        # mask[None, None, None]
        m = mask[:, None, None] if mask.ndim == 3 else \
            mask.expand(1, 1, 1, *mask.shape)
        scores = torch.where(m, scores, -1e30)
    probs = softmax(scores).to(v.dtype)
    out = einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(B, S, h * hd)


def causal_mask(S, T, window=0, device=None):
    """(S, T) mask of keys each query may see (query 0 at key 0)."""
    qp = torch.arange(S, device=device)[:, None]
    kp = torch.arange(T, device=device)[None, :]
    m = qp >= kp
    if window:
        m = m & ((qp - kp) < window)
    return m


def attn_apply(cfg, p, x, positions, *, window=0, is_causal=True):
    """Full-sequence self-attention (train / prefill)."""
    h = rmsnorm(x, p["ln"])
    q, k, v = _project_qkv(cfg, p, h, positions)
    if getattr(cfg, "use_pallas", False) and window == 0:
        # fused kernel path: expand GQA groups so the fused op's head
        # dim is shared across q/k/v (mappable by the plan), then
        # dispatch through kernels.ops — traced as a single
        # kernel:flash_attention IR op
        g = cfg.num_heads // cfg.num_kv_heads
        kf = repeat_heads(k, g) if g > 1 else k
        vf = repeat_heads(v, g) if g > 1 else v
        out = kernel_ops.attention(q, kf, vf, causal=is_causal)
        out = out.reshape(*out.shape[:2], -1)
        out = constrain(out, ("act_batch", "seq", "heads"))
        return x + matmul(out, p["wo"])
    S = x.shape[1]
    mask = replicate_like(causal_mask(S, S, window, device=x.device), x) \
        if is_causal else None
    out = attn_core(cfg, q, k, v, mask)
    out = constrain(out, ("act_batch", "seq", "heads"))
    return x + matmul(out, p["wo"])


def attn_init_cache(cfg, batch, max_seq, window=0, device=None):
    """One attention block's decode cache: a ring of ``T`` key / value
    slots (``T = min(window, max_seq)`` when windowed) and the position
    each slot holds (-1: empty)."""
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    T = min(window, max_seq) if window else max_seq
    return {
        "k": torch.zeros((batch, T, kvh, hd), dtype=cfg.dtype,
                         device=device),
        "v": torch.zeros((batch, T, kvh, hd), dtype=cfg.dtype,
                         device=device),
        "slot_pos": torch.full((T,), -1, dtype=torch.int32, device=device),
    }


def attn_decode(cfg, p, x, cache, pos, *, window=0, enc_out=None):
    """One-token self-attention decode. x: (B,1,D); pos: 0-d int32.

    The new key and value go to slot ``pos % T`` of the ring; a slot is
    visible when it holds a position in ``[0, pos]`` (and, windowed,
    within ``window`` of ``pos``).  Returns the output and the new cache;
    the old cache is not written.
    """
    if enc_out is not None:
        raise NotImplementedError(
            "cross-attention decode is not ported yet (ROADMAP queue 1, "
            "item 11)")
    h = rmsnorm(x, p["ln"])
    # the query's and the key's position, each its own (1, 1) broadcast
    # of pos as the reference's pos[None, None]
    q, k_new, v_new = _project_qkv(cfg, p, h, pos.expand(1, 1),
                                   pos.expand(1, 1))
    T = cache["k"].shape[1]
    # the slot as a one-element index: the tracer lowers index_copy to
    # the reference's dynamic_update_slice at this scalar
    idx = (pos % T).to(torch.int64)[None]
    k = index_copy(cache["k"], 1, idx, k_new)
    v = index_copy(cache["v"], 1, idx, v_new)
    slot_pos = index_copy(cache["slot_pos"], 0, idx, pos[None])
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if window:
        valid = valid & ((pos - slot_pos) < window)
    out = attn_core(cfg, q, k, v, valid.expand(1, 1, T))
    return x + matmul(out, p["wo"]), {"k": k, "v": v, "slot_pos": slot_pos}


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_param_shapes(cfg) -> dict:
    """Shapes and init kinds of one MLP block's parameters."""
    d, f = cfg.d_model, cfg.d_ff
    return {"ln": ((d,), "ones"), "wi": ((d, f), "dense"),
            "wo": ((f, d), "dense"), "wg": ((d, f), "dense")}


def mlp_apply(cfg, p, x):
    """SwiGLU MLP block (pre-norm residual)."""
    h = rmsnorm(x, p["ln"])
    u = matmul(h, p["wi"])
    u = constrain(u, ("act_batch", "seq", "hidden"))
    gate = matmul(h, p["wg"])
    u = gate * torch.sigmoid(gate) * u
    return x + matmul(u, p["wo"])


# ---------------------------------------------------------------------------
# RG-LRU (Griffin)
# ---------------------------------------------------------------------------

_RG_C = 8.0
_CONV_K = 4


def rnn_width(cfg) -> int:
    """Width of the RG-LRU block's recurrence (3/2 of d_model)."""
    return (cfg.d_model * 3) // 2


def rglru_param_shapes(cfg) -> dict:
    """Shapes and init kinds of one RG-LRU block's parameters."""
    d, r = cfg.d_model, rnn_width(cfg)
    return {"ln": ((d,), "ones"), "wx": ((d, r), "dense"),
            "wy": ((d, r), "dense"), "wo": ((r, d), "dense"),
            "conv_w": ((_CONV_K, r), "conv"), "conv_b": ((r,), "zeros"),
            # diagonal gate parametrisation (per-channel weight + bias)
            "ga_w": ((r,), "gate"), "ga_b": ((r,), "zeros"),
            "gi_w": ((r,), "gate"), "gi_b": ((r,), "zeros"),
            # Λ in [4, 6), so a = σ(Λ)^c starts near 0.9..0.999
            "lam": ((r,), "lam")}


def gelu(x):
    """``jax.nn.gelu`` in its default tanh form, step for step, with its
    constants rounded to x's dtype as the reference rounds them."""
    c = round_to(x.dtype, 0.044715)
    k = round_to(x.dtype, math.sqrt(2 / math.pi))
    cdf = 0.5 * (1.0 + torch.tanh(k * (x + c * x ** 3)))
    return x * cdf


def softplus(x):
    """``jax.nn.softplus``, written out as its ``logaddexp(x, 0)``."""
    amax = torch.clamp_min(x, 0.0)
    delta = x - 0.0
    return torch.where(pointwise(torch.ne, delta, delta), x + 0.0,
                       amax + torch.log1p(torch.exp(-delta.abs())))


def _causal_conv4(u, w, b, state=None):
    """Depthwise causal conv, kernel 4, from ``state`` (B,3,r) or, with
    none (prefill), from zeros.

    u: (B,S,r); w: (4,r); b: (r,).  Returns the output and the last 3
    inputs (the decode state), as the reference does.
    """
    pad = torch.zeros_like(u[:, :_CONV_K - 1]) if state is None else state
    ext = torch.cat([pad, u], 1)                           # (B, S+3, r)
    S = u.shape[1]
    out = sum(ext[:, i:i + S] * w[_CONV_K - 1 - i] for i in range(_CONV_K))
    new_state = ext[:, -(_CONV_K - 1):]
    return out + b, new_state


def _rglru_gates(p, u):
    """Decay ``a`` and input term of the recurrence, both float32."""
    rt = torch.sigmoid(u * p["ga_w"] + p["ga_b"]).to(torch.float32)
    it = torch.sigmoid(u * p["gi_w"] + p["gi_b"]).to(torch.float32)
    log_a = -_RG_C * rt * softplus(p["lam"].to(torch.float32))
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-6))
    bterm = beta * (it * u.to(torch.float32))
    return a, bterm


def rglru_apply(cfg, p, x):
    """Griffin RG-LRU block (pre-norm residual), full sequence."""
    h = rmsnorm(x, p["ln"])
    u = matmul(h, p["wx"])
    u, _ = _causal_conv4(u, p["conv_w"], p["conv_b"])
    u = constrain(u, ("act_batch", "seq", "rnn"))
    a, bterm = _rglru_gates(p, u)
    if getattr(cfg, "use_pallas", False):
        # fused kernel path — traced as a single kernel:rg_lru IR op
        hseq = kernel_ops.rg_lru(a, bterm)
    else:
        _, hseq = lru_associative_scan(a, bterm)
    y = gelu(matmul(h, p["wy"])) * hseq.to(x.dtype)
    return x + matmul(y, p["wo"])


def rglru_init_cache(cfg, batch, device=None):
    """One RG-LRU block's decode state: the recurrence ``h`` (float32) and
    the conv's last 3 inputs."""
    r = rnn_width(cfg)
    return {"h": torch.zeros((batch, r), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, _CONV_K - 1, r), dtype=cfg.dtype,
                                device=device)}


def rglru_decode(cfg, p, x, cache, pos):
    """One-token RG-LRU decode: one step ``h = a*h + b``. x: (B,1,D)."""
    h = rmsnorm(x, p["ln"])
    u = matmul(h, p["wx"])                                   # (B,1,r)
    u, conv_state = _causal_conv4(u, p["conv_w"], p["conv_b"],
                                  cache["conv"])
    a, bterm = _rglru_gates(p, u)
    hnew = a[:, 0] * cache["h"] + bterm[:, 0]               # (B,r)
    y = gelu(matmul(h, p["wy"])) * hnew[:, None].to(x.dtype)
    return x + matmul(y, p["wo"]), {"h": hnew, "conv": conv_state}
