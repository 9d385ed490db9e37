"""Model building blocks in PyTorch: the dense decoder's, the hybrid's,
the mixture-of-experts models' and xLSTM's parts.

Ported so far: RMSNorm, RoPE, GQA attention (full, sliding-window and
non-causal masking; the einsum path and the fused-kernel path; the
one-token decode form over a ring-buffer KV cache), the SwiGLU MLP, the
MoE block (top-k router, capacity-bounded gather / scatter-add dispatch
in the global, batch and local modes, Arctic's dense residual path) and
the Griffin RG-LRU block (full sequence, on the associative-scan path
or the fused-kernel path; the one-token decode form over its recurrent
and conv state) and the xLSTM blocks (the mLSTM's stabilised parallel
form and the sLSTM's recurrence scanned over time, each with its
one-token decode form), cross-attention (an encoder-decoder's decoder
attending to the encoder's output: no RoPE, no mask, the einsum path)
and the GELU MLP.

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
from repro_torch.models import sharding
from repro_torch.models.sharding import (constrain, einsum, index_copy,
                                        matmul, pointwise, reduced_onto,
                                        replicate_like, split_dim)

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


def _project_qkv(cfg, p, xq, xkv, q_positions, kv_positions,
                 use_rope=True):
    """Queries from ``xq``, keys and values from ``xkv`` (the same
    tensor in self-attention), split into heads; RoPE on the queries and
    keys unless ``use_rope`` is false (cross-attention)."""
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = matmul(xq, p["wq"])
    k = matmul(xkv, p["wk"])
    v = matmul(xkv, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = split_dim(q, -1, (h, hd))
    if use_rope:
        q = rope(q, q_positions, cfg.rope_theta)
    k = split_dim(k, -1, (kv, hd))
    if use_rope:
        k = rope(k, kv_positions, cfg.rope_theta)
    return q, k, split_dim(v, -1, (kv, hd))


def _cross_qkv(cfg, p, h, x, enc_out):
    """Cross-attention's projections: queries from ``h``, keys and
    values from ``enc_out`` cast to ``x``'s dtype, no RoPE (the
    reference makes positions for both, which it never reads)."""
    enc_out = enc_out.to(x.dtype)
    return _project_qkv(cfg, p, h, enc_out, None, None, use_rope=False)


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


def attn_apply(cfg, p, x, positions, *, window=0, is_causal=True,
               enc_out=None):
    """Full-sequence attention (train / prefill): self-attention, or with
    ``enc_out`` cross-attention to it (the einsum path, no mask, never
    the kernel, as in the reference)."""
    h = rmsnorm(x, p["ln"])
    if enc_out is not None:
        q, k, v = _cross_qkv(cfg, p, h, x, enc_out)
        out = attn_core(cfg, q, k, v, None)
        out = constrain(out, ("act_batch", "seq", "heads"))
        return x + matmul(out, p["wo"])
    q, k, v = _project_qkv(cfg, p, h, h, positions, positions)
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
    """One-token attention decode. x: (B,1,D); pos: 0-d int32.

    Self-attention: the new key and value go to slot ``pos % T`` of the
    ring; a slot is visible when it holds a position in ``[0, pos]``
    (and, windowed, within ``window`` of ``pos``).  Returns the output
    and the new cache; the old cache is not written.

    With ``enc_out``, cross-attention: the keys and values are projected
    from ``enc_out`` anew at every step (there is no cross cache, as in
    the reference), nothing is masked, and ``cache`` is returned as it
    came (``None`` from ``decode_block``).
    """
    h = rmsnorm(x, p["ln"])
    if enc_out is not None:
        q, k, v = _cross_qkv(cfg, p, h, x, enc_out)
        out = attn_core(cfg, q, k, v, None)
        return x + matmul(out, p["wo"]), cache
    # the query's and the key's position, each its own (1, 1) broadcast
    # of pos as the reference's pos[None, None]
    q, k_new, v_new = _project_qkv(cfg, p, h, h, pos.expand(1, 1),
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
    """Shapes and init kinds of one MLP block's parameters (the gate
    ``wg`` in the SwiGLU form only)."""
    d, f = cfg.d_model, cfg.d_ff
    p = {"ln": ((d,), "ones"), "wi": ((d, f), "dense"),
         "wo": ((f, d), "dense")}
    if cfg.mlp == "swiglu":
        p["wg"] = ((d, f), "dense")
    return p


def mlp_apply(cfg, p, x):
    """SwiGLU or GELU MLP block (pre-norm residual)."""
    h = rmsnorm(x, p["ln"])
    u = matmul(h, p["wi"])
    u = constrain(u, ("act_batch", "seq", "hidden"))
    if cfg.mlp == "swiglu":
        gate = matmul(h, p["wg"])
        u = gate * torch.sigmoid(gate) * u
    else:
        u = gelu(u)
    return x + matmul(u, p["wo"])


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


@torch.library.custom_op("repro_torch::top_k", mutates_args=())
def _top_k_op(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    # a stable descending sort keeps equal values in index order
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k].contiguous(), indices[..., :k].contiguous()


@_top_k_op.register_fake
def _(x, k):
    shape = (*x.shape[:-1], k)
    return x.new_empty(shape), x.new_empty(shape, dtype=torch.int64)


def _top_k_setup(ctx, inputs, output):
    ctx.shape = inputs[0].shape
    ctx.save_for_backward(output[1])


def _top_k_backward(ctx, g_values, g_indices):
    # lax.top_k's JVP gathers the tangent at the indices; its transpose
    # adds the values' cotangent into zeros there.  The indices take none
    (idx,) = ctx.saved_tensors
    return g_values.new_zeros(ctx.shape).scatter_add(-1, idx, g_values), \
        None


_top_k_op.register_autograd(_top_k_backward, setup_context=_top_k_setup)


def top_k(x, k: int):
    """``lax.top_k``: the ``k`` largest values along the last dim and
    their (int64) indices, largest first and, among equal values, the
    lower index first, on every device (``torch.topk`` promises no tie
    order).  One op, ``repro_torch::top_k``, which the tracer lowers to
    the reference's ``top_k`` prim; on DTensors it runs per shard
    (``sharding.top_k``).  Differentiable in the values, as
    ``lax.top_k``: their cotangent goes into zeros of ``x``'s shape at
    the indices."""
    return sharding.top_k(_top_k_op, x, k)


def _gather(arr, idx, axis: int):
    shape = [i if a == 1 else a for a, i in zip(arr.shape, idx.shape)]
    arr_shape, idx_shape = list(shape), list(shape)
    arr_shape[axis], idx_shape[axis] = arr.shape[axis], idx.shape[axis]
    return torch.gather(arr.expand(arr_shape), axis, idx.expand(idx_shape))


def take_along_axis(arr, idx, axis: int):
    """``jnp.take_along_axis``: ``arr`` and ``idx`` of one rank broadcast
    against each other on every dim but ``axis``.  Both are expanded and
    gathered; the tracer lowers the gather of the two expansions to the
    reference's one gather of the unexpanded operands.  On DTensors it
    runs per shard (``sharding.take_along_axis``)."""
    return sharding.take_along_axis(_gather, arr, idx, axis % arr.ndim)


def _scatter_add(base, dim: int, idx, upd):
    return base.scatter_add(dim, idx[..., None].expand(upd.shape), upd)


def scatter_add_rows(base, dim: int, idx, upd):
    """``base.at[..., idx, ...].add(upd)`` along ``dim``, under ``vmap``
    over the dims before it: the reference's per-row combine.

    base: (*lead, N, d); idx: (*lead, n) int; upd: (*lead, n, d).  The
    index is expanded over ``d`` for ``scatter_add``; the tracer lowers
    the two to the reference's one ``scatter-add`` of the unexpanded
    index (batching dims ``lead``, window dim ``d``).  On DTensors it
    runs per shard (``sharding.scatter_add``).
    """
    return sharding.scatter_add(_scatter_add, base, dim, idx, upd)


# the stacked expert weights, (E, d, f) and (E, f, d)
EXPERT_STACKS = ("wi", "wgate", "wo")


def moe_param_shapes(cfg) -> dict:
    """Shapes and init kinds of one MoE block's parameters: the router
    ``wg`` (d, E), the experts' SwiGLU weights stacked (E, d, f) /
    (E, f, d), and with ``moe_dense_residual`` a dense SwiGLU beside
    them."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {"ln": ((d,), "ones"), "wg": ((d, e), "dense"),
         "wi": ((e, d, f), "dense"), "wgate": ((e, d, f), "dense"),
         "wo": ((e, f, d), "dense")}
    if cfg.moe_dense_residual:
        p["dense_wi"] = ((d, f), "dense")
        p["dense_wg"] = ((d, f), "dense")
        p["dense_wo"] = ((f, d), "dense")
    return p


def moe_apply(cfg, p, x, capacity_factor=None):
    """Top-k routing with per-expert capacity (gather / scatter-add
    dispatch), pre-norm residual.

    Tokens beyond an expert's capacity are dropped (Switch-style), as in
    the reference; ``capacity_factor`` defaults from the config.  The
    dispatch mode is ``cfg.moe_dispatch``: ``"global"`` routes one pool
    of B*S tokens, ``"batch"`` each batch row, ``"local"`` each of
    ``cfg.moe_local_pools`` sequence pools of each row.  Every shape is
    static (no data-dependent sizes), so the block captures in a CUDA
    graph.

    On DTensors (a mesh of two or more devices) the block runs as GSPMD
    runs the reference's expert-sharded plans: the router's and the
    dense path's weights are gathered as a dense block's
    (``sharding.gather_for``), the expert stacks stay where the plan put
    them and the dispatched tokens move to their experts
    (``sharding.einsum``), the plain tensors the block makes (zeros, the
    experts' iota) are replicated beside the activations, the top-k, the
    dispatch gather and the combine run per shard (``sharding.top_k``,
    ``sharding.take_along_axis``, ``sharding.lookup``,
    ``sharding.scatter_add``), and the combined output, a pending sum
    where the experts are sharded, is reduced once onto the residual's
    placement.
    """
    capacity_factor = capacity_factor or cfg.moe_capacity_factor
    # the router's and the dense path's weights gathered as a dense
    # block's are; the expert stacks stay where the plan put them
    p = {k: w if k in EXPERT_STACKS else sharding.gather_for(w, x)
         for k, w in p.items()}
    h = rmsnorm(x, p["ln"])
    if cfg.moe_dispatch == "local":
        y = _moe_dispatch_local(cfg, p, h, capacity_factor,
                                cfg.moe_local_pools)
    elif cfg.moe_dispatch == "batch":
        y = _moe_dispatch_batch(cfg, p, h, capacity_factor)
    else:
        y = _moe_dispatch_global(cfg, p, h, capacity_factor)
    if cfg.moe_dense_residual:
        gate = matmul(h, p["dense_wg"])
        u = gate * torch.sigmoid(gate) * matmul(h, p["dense_wi"])
        y = y + matmul(u, p["dense_wo"])
    return x + reduced_onto(y, x)


def _router(cfg, p, h):
    """Top-k routing weights as a dense (..., E) float32 matrix: the
    softmax of the router's logits, its top k renormalized, zero
    elsewhere."""
    e, k = cfg.num_experts, cfg.experts_per_token
    logits = matmul(h, p["wg"]).to(torch.float32)
    probs = softmax(logits)
    topw, topi = top_k(probs, k)
    topw = topw / topw.sum(-1, keepdim=True)
    W = replicate_like(torch.zeros(probs.shape, dtype=torch.float32,
                                   device=h.device), probs)
    for j in range(k):
        # jax.nn.one_hot: the index against an iota of the experts
        iota = replicate_like(torch.arange(e, device=h.device), probs)
        hot = (topi[..., j][..., None] == iota).to(torch.float32)
        W = W + hot * topw[..., j:j + 1]
    return W


def _expert_ffn(p, xe):
    """xe: (..., E, C, d) with stacked expert weights (E, d, f)."""
    lead = "bp"[:xe.ndim - 3]
    up = f"{lead}ecd,edf->{lead}ecf"
    xe = sharding.einsum_inputs(up, xe, p["wgate"])[0]
    # a pending sum of the gate (its stack placed otherwise than the
    # input's, e.g. sharded on its layers) reduced onto the input
    # product's shard of the experts, not made whole
    gate = sharding.reduced_for_einsum(einsum(up, xe, p["wgate"]), up, xe,
                                       p["wi"])
    he = gate * torch.sigmoid(gate) * einsum(up, xe, p["wi"])
    he = constrain(he, ("act_batch", "experts", None, "hidden")[-he.ndim:])
    return einsum(f"{lead}ecf,efd->{lead}ecd", he, p["wo"])


def _clip(n, lo, hi):
    """``max(lo, min(n, hi))`` by comparisons: inside the layer scan's
    body, which ``torch.export`` traces with dynamo, shapes are symbolic
    ints, and dynamo (torch 2.13) gives ``max(1, n)`` of one as 1."""
    if n > hi:
        n = hi
    if n < lo:
        n = lo
    return n


def capacity(cfg, tokens: int, capacity_factor: float) -> int:
    """Each expert's capacity in a pool of ``tokens`` tokens."""
    e, k = cfg.num_experts, cfg.experts_per_token
    return _clip(int(math.ceil(k * tokens / e * capacity_factor)), 1,
                 tokens)


def _moe_dispatch_global(cfg, p, h, capacity_factor):
    B, S, d = h.shape
    e = cfg.num_experts
    xf = h.reshape(B * S, d)
    T = B * S
    W = _router(cfg, p, xf)                                     # (T, E)
    C = capacity(cfg, T, capacity_factor)
    wsel, tsel = top_k(W.t(), C)                                # (E, C)
    xe = sharding.lookup(torch.nn.functional.embedding, tsel.reshape(-1),
                         xf).reshape(e, C, d)
    xe = constrain(xe, ("experts", None, None))
    ye = _expert_ffn(p, xe) * wsel[..., None].to(h.dtype)
    y = replicate_like(torch.zeros((T, d), dtype=h.dtype, device=h.device),
                       h)
    return scatter_add_rows(y, 0, tsel.reshape(-1), ye.reshape(e * C, d)
                            ).reshape(B, S, d)


def _moe_dispatch_batch(cfg, p, h, capacity_factor):
    B, S, d = h.shape
    e = cfg.num_experts
    W = _router(cfg, p, h)                                      # (B, S, E)
    C = capacity(cfg, S, capacity_factor)
    wsel, tsel = top_k(W.permute(0, 2, 1), C)                   # (B, E, C)
    xe = take_along_axis(h[:, None], tsel[..., None], 2)        # (B,E,C,d)
    xe = constrain(xe, ("act_batch", "experts", None, None))
    ye = _expert_ffn(p, xe) * wsel[..., None].to(h.dtype)
    ye = constrain(ye, ("act_batch", "experts", None, None))
    idx, upd = tsel.reshape(B, e * C), ye.reshape(B, e * C, d)
    # the reference's vmap'd combine: one zero (S, d) per row
    base = replicate_like(torch.zeros((S, d), dtype=h.dtype,
                                      device=h.device), h).expand(B, S, d)
    return scatter_add_rows(base, 1, idx, upd)


def _moe_dispatch_local(cfg, p, h, capacity_factor, pools):
    """Route within (batch row x sequence pool); capacity per pool."""
    B, S, d = h.shape
    e = cfg.num_experts
    pools = _clip(pools or 1, 1, S)
    Sl = S // pools
    hp = h.reshape(B, pools, Sl, d)
    hp = constrain(hp, ("act_batch", "seq", None, None))
    W = _router(cfg, p, hp)                                  # (B,P,Sl,E)
    C = capacity(cfg, Sl, capacity_factor)
    wsel, tsel = top_k(W.permute(0, 1, 3, 2), C)             # (B,P,E,C)
    xe = take_along_axis(hp[:, :, None], tsel[..., None], 3)  # (B,P,E,C,d)
    xe = constrain(xe, ("act_batch", "seq", "experts", None, None))
    ye = _expert_ffn(p, xe) * wsel[..., None].to(h.dtype)
    idx, upd = tsel.reshape(B, pools, e * C), ye.reshape(B, pools, e * C, d)
    # vmap(vmap(combine)): one zero (Sl, d) per pool, per row
    base = replicate_like(torch.zeros((Sl, d), dtype=h.dtype,
                                      device=h.device), h).expand(
        pools, Sl, d).expand(B, pools, Sl, d)
    return scatter_add_rows(base, 2, idx, upd).reshape(B, S, d)


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


# ---------------------------------------------------------------------------
# xLSTM blocks
# ---------------------------------------------------------------------------


def mlstm_param_shapes(cfg) -> dict:
    """Shapes and init kinds of one mLSTM block's parameters."""
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    return {"ln": ((d,), "ones"), "wq": ((d, h * hd), "dense"),
            "wk": ((d, h * hd), "dense"), "wv": ((d, h * hd), "dense"),
            "wi": ((d, h), "dense"), "wf": ((d, h), "dense"),
            "wo": ((h * hd, d), "dense")}


def mlstm_apply(cfg, p, x):
    """Parallel (stabilised quadratic) mLSTM forward, full sequence.

    The decay matrix ``D[b,h,i,j] = exp(F_i - F_j + ig_j - max(m_i, 0))``
    (``F`` the log-forget-gate prefix sum, ``m_i`` its row max, keys
    after the query masked to ``-inf``) weighs the query-key products;
    the normaliser is ``max(|row sum|, exp(-max(m, 0)))``.
    """
    B, S, _ = x.shape
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    # every query meets every key: on a mesh the block runs on the whole
    # sequence (sharding.whole_along), as GSPMD runs it, its input moved
    # once for its five projections (sharding.matmul_input)
    xn = sharding.whole_along(rmsnorm(x, p["ln"]), 1, "mLSTM sequence")
    xn = sharding.matmul_input(xn, p["wq"])
    q = split_dim(matmul(xn, p["wq"]), -1, (h, hd))
    k = split_dim(matmul(xn, p["wk"]), -1, (h, hd)) / round_to(
        x.dtype, math.sqrt(hd))
    v = split_dim(matmul(xn, p["wv"]), -1, (h, hd))
    # a pending sum reduced at (B, S, h), before it broadcasts over keys
    ig = sharding.reduced(matmul(xn, p["wi"])).to(torch.float32)
    fg = matmul(xn, p["wf"]).to(torch.float32)
    logf = -softplus(-fg)                                    # log σ(f)
    F = sharding.cumsum(logf, 1)
    # logD[b,h,i,j] = F_i - F_j + ig_j   (j <= i)
    logD = (F.permute(0, 2, 1)[:, :, :, None] -
            F.permute(0, 2, 1)[:, :, None, :] +
            ig.permute(0, 2, 1)[:, :, None, :])
    mask = replicate_like(torch.tril(torch.ones(
        (S, S), dtype=torch.bool, device=x.device)), logD)
    logD = torch.where(mask[None, None], logD, -math.inf)
    m = logD.amax(-1, keepdim=True)                          # (B,h,S,1)
    D = torch.exp(logD - torch.clamp_min(m, 0.0))
    Sqk = einsum("bshd,bthd->bhst", q, k).to(torch.float32) * D
    Sqk = constrain(Sqk, ("act_batch", "heads", "seq", None))
    n = torch.maximum(torch.abs(Sqk.sum(-1, keepdim=True)),
                      torch.exp(-torch.clamp_min(m, 0.0)))
    out = einsum("bhst,bthd->bshd", (Sqk / n).to(v.dtype), v)
    return x + matmul(out.reshape(B, S, h * hd), p["wo"])


def mlstm_init_cache(cfg, batch, device=None):
    """One mLSTM block's decode state, all float32: the matrix memory
    ``C``, the normaliser ``n`` and the stabiliser ``m``."""
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    return {"C": torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                             device=device),
            "n": torch.zeros((batch, h, hd), dtype=torch.float32,
                             device=device),
            "m": torch.zeros((batch, h), dtype=torch.float32,
                             device=device)}


def mlstm_decode(cfg, p, x, cache, pos):
    """One-token mLSTM decode: the recurrent form of
    :func:`mlstm_apply`. x: (B,1,D)."""
    B = x.shape[0]
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    xn = rmsnorm(x, p["ln"])
    q = matmul(xn, p["wq"]).reshape(B, h, hd)
    k = matmul(xn, p["wk"]).reshape(B, h, hd) / round_to(
        x.dtype, math.sqrt(hd))
    v = matmul(xn, p["wv"]).reshape(B, h, hd)
    ig = matmul(xn, p["wi"]).to(torch.float32).reshape(B, h)
    fg = matmul(xn, p["wf"]).to(torch.float32).reshape(B, h)
    logf = -softplus(-fg)
    m_new = torch.maximum(logf + cache["m"], ig)
    fsc = torch.exp(logf + cache["m"] - m_new)[..., None]
    isc = torch.exp(ig - m_new)[..., None]
    C = fsc[..., None] * cache["C"] + \
        isc[..., None] * (v[..., :, None] * k[..., None, :])
    nvec = fsc * cache["n"] + isc * k
    hn = einsum("bhij,bhj->bhi", C, q.to(torch.float32))
    denom = torch.maximum(torch.abs((nvec * q).sum(-1, keepdim=True)),
                          torch.exp(-m_new)[..., None])
    out = (hn / denom).to(x.dtype).reshape(B, 1, h * hd)
    return x + matmul(out, p["wo"]), {"C": C, "n": nvec, "m": m_new}


def slstm_param_shapes(cfg) -> dict:
    """Shapes and init kinds of one sLSTM block's parameters: the input
    weights ``W`` of the four gates, their per-head recurrent weights
    ``R`` and bias ``b``."""
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    return {"ln": ((d,), "ones"), "W": ((d, 4 * h * hd), "dense"),
            "R": ((h, hd, 4 * hd), "dense"),
            "b": ((4 * h * hd,), "zeros"),
            "wo": ((h * hd, d), "dense")}


def _slstm_step(cfg, p, carry, pre_x):
    """One sLSTM step. carry: (c, n, hst, m), each (B,h,hd) float32;
    pre_x: (B, 4*h*hd), the input's gate pre-activations; ``h`` is
    ``R``'s (a rank's heads in the per-shard loop)."""
    h_, hd = p["R"].shape[0], cfg.resolved_head_dim
    c, n, hst, m = carry
    rec = einsum("bij,ijk->bik", hst.to(p["R"].dtype), p["R"])
    pre = pre_x.reshape(*pre_x.shape[:-1], h_, 4 * hd) + rec
    zi, ii, fi, oi = torch.split(pre.to(torch.float32), hd, dim=-1)
    z = torch.tanh(zi)
    o = torch.sigmoid(oi)
    logf = -softplus(-fi)
    m_new = torch.maximum(logf + m, ii)
    isc = torch.exp(ii - m_new)
    fsc = torch.exp(logf + m - m_new)
    c_new = fsc * c + isc * z
    n_new = torch.clamp_min(fsc * n + isc, 1.0)
    h_new = o * c_new / n_new
    return (c_new, n_new, h_new, m_new), h_new


def _slstm_scan(cfg, pre, R):
    """The sLSTM's recurrence over time: pre (B, S, h*4hd) the gates'
    input products, R (h, hd, 4hd) -> hs (B, S, h*hd) float32."""
    from repro_torch.models.transformer import scan_layers
    B, S, _ = pre.shape
    h_, hd = R.shape[0], cfg.resolved_head_dim
    z = torch.zeros((B, h_, hd), dtype=torch.float32, device=pre.device)
    # three carries start from one zeros value, as in the reference; each
    # is a tensor of its own, or the exported scan body reads one of them
    # for all three (the tracer lowers the copies as the value itself)
    carry = (z, z.clone(), z.clone(),
             torch.zeros((B, h_, hd), dtype=torch.float32,
                         device=pre.device))

    def step(c, pre_t):
        c, h_new = _slstm_step(cfg, {"R": R}, c, pre_t)
        # a scan's output may not alias another: ys get their own copy
        return c, h_new.clone()

    _, hs = scan_layers(step, carry, pre.permute(1, 0, 2), with_ys=True)
    return hs.permute(1, 0, 2, 3).reshape(B, S, h_ * hd)


def slstm_apply(cfg, p, x):
    """sLSTM block (pre-norm residual), full sequence: the gates' input
    products for every step at once, then the recurrence scanned over
    time (``transformer.scan_layers``: one ``scan`` under
    ``torch.export``, a loop eagerly).

    On DTensors the whole loop runs per shard
    (``sharding.scan_per_shard``): the batch and the heads stay as the
    plan put them (``R`` with its head shard, gathered where ``pre``'s
    batch lies), and the time dim and ``R``'s ``hd`` and gate dims are
    made whole once, before the loop.
    """
    xn = rmsnorm(x, p["ln"])
    pre = matmul(xn, p["W"]) + p["b"]                        # (B,S,h*4hd)
    # "H": the heads, whole head blocks of pre's h*4hd and of hs's h*hd
    out = sharding.scan_per_shard(
        lambda pre_, r: _slstm_scan(cfg, pre_, r), [pre, p["R"]],
        ["bsH", "Hjk"], "bsH", whole="sjk", movable=(1,))
    return x + matmul(out.to(x.dtype), p["wo"])


def slstm_init_cache(cfg, batch, device=None):
    """One sLSTM block's decode state: the carries ``c``, ``n``, ``h``
    and ``m``, each (B, h, hd) float32."""
    h_, hd = cfg.num_heads, cfg.resolved_head_dim
    return {k: torch.zeros((batch, h_, hd), dtype=torch.float32,
                           device=device) for k in ("c", "n", "h", "m")}


def slstm_decode(cfg, p, x, cache, pos):
    """One-token sLSTM decode: one step of the recurrence. x: (B,1,D)."""
    B = x.shape[0]
    h_, hd = cfg.num_heads, cfg.resolved_head_dim
    xn = rmsnorm(x, p["ln"])
    pre = (matmul(xn, p["W"]) + p["b"])[:, 0]
    carry = (cache["c"], cache["n"], cache["h"], cache["m"])
    carry, h_new = _slstm_step(cfg, p, carry, pre)
    out = h_new.reshape(B, 1, h_ * hd).to(x.dtype)
    cache = {"c": carry[0], "n": carry[1], "h": carry[2], "m": carry[3]}
    return x + matmul(out, p["wo"]), cache
