"""Model stack in PyTorch: parameters, the full-sequence forward and the
one-token decode step.

A model is ``init_params(cfg, generator)`` + ``forward(cfg, params,
tokens)``, and for decode ``init_cache(cfg, batch, max_seq)`` +
``decode_step(cfg, params, cache, token, pos)`` — plain functions over
parameter and cache trees in the reference package's layout, so traced
programs name the same input paths.

Depth runs as a scan over *super-blocks* exactly as in the reference:
the layer pattern's period defines one super-block whose parameters are
stacked ``num_layers // period`` deep in ``params["layers"]``, and
left-over layers run unscanned as the ``tail``.  :func:`scan_layers` is
the one helper that runs that depth: under ``torch.export`` it emits one
``torch._higher_order_ops.scan`` (the tracer instantiates its body once,
the structural analogue of the paper's §4.4 repeated-layer grouping);
run eagerly it is a plain loop giving the same result.  Decode scans the
stacked caches beside the parameters and returns the new caches stacked,
as ``lax.scan``'s ``ys``.  Under ``cfg.remat`` a training run (grad
enabled, eager) checkpoints each layer body, as the reference's
``jax.checkpoint``; the forward values do not change.

Ported block kinds: ``attn``, ``local`` and ``rglru``, with the dense
MLP (SwiGLU or GELU), and with the MoE block after attention in a model
with experts (``mixtral_8x22b``, ``arctic_480b``), and xLSTM's ``mlstm``
and ``slstm`` (``xlstm_350m``; the sLSTM's time scan runs inside the
layer scan's body).  The frontends are the reference's stubs: an
encoder-decoder model (``whisper_small``) takes precomputed frame
embeddings, which :func:`encode` runs through its own non-causal layer
scan (``enc_layers``) before the decoder, whose blocks each add a
cross-attention to the encoder's output; a vision model
(``phi3_vision``) takes precomputed patch embeddings, concatenated
before the token embeddings.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.sharding import (cat_like, constrain, embedding,
                                        gather_for, get_kernel_dispatch,
                                        get_rules, kernel_dispatch, layer,
                                        logical_rules, matmul,
                                        replicate_like)


def block_kinds(cfg) -> tuple[tuple[str, ...], tuple[str, ...]]:
    """(period kinds, tail kinds)."""
    pattern = cfg.pattern
    period = len(cfg.block_pattern) or 1
    n_scan = cfg.num_layers // period
    return pattern[:period], pattern[n_scan * period:]


def n_scan_blocks(cfg) -> int:
    period = len(cfg.block_pattern) or 1
    return cfg.num_layers // period


def kernel_sites(cfg) -> dict[str, tuple[int, int]]:
    """Per fused kernel, its call sites under ``use_pallas`` in the scanned
    period and in the tail: an RG-LRU block calls the scan, full
    attention flash attention, windowed attention none (its einsum
    path), the xLSTM blocks none, cross-attention none.  An
    encoder-decoder model's encoder layer (one site, non-causal) counts
    in the scanned period beside the decoder's."""
    def kernel(kind):
        if kind == "rglru":
            return "rg_lru"
        if kind not in ("attn", "local"):
            return None
        window = cfg.sliding_window if kind == "attn" else cfg.local_window
        return "flash_attention" if window == 0 else None

    period, tail = block_kinds(cfg)
    enc = ("attn",) if cfg.is_encoder_decoder else ()
    return {k: (sum(kernel(x) == k for x in enc + period),
                sum(kernel(x) == k for x in tail))
            for k in ("flash_attention", "rg_lru")}


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def _is_moe(cfg, kind) -> bool:
    """Whether a ``kind`` layer's feed-forward is the MoE block."""
    return bool(cfg.num_experts) and kind in ("attn", "local")


def _block_shapes(cfg, kind, *, cross=False) -> dict:
    """One block's parameter shapes; ``cross``: a decoder block of an
    encoder-decoder model, with its cross-attention (its leaves flatten
    as ``cross``, ``ffn``, ``mix``: sorted keys, as in the reference)."""
    mix = {"rglru": L.rglru_param_shapes, "mlstm": L.mlstm_param_shapes,
           "slstm": L.slstm_param_shapes}.get(kind, L.attn_param_shapes)
    p = {"mix": mix(cfg)}
    if cross:
        p["cross"] = L.attn_param_shapes(cfg)
    if cfg.d_ff > 0:
        p["ffn"] = L.moe_param_shapes(cfg) if _is_moe(cfg, kind) else \
            L.mlp_param_shapes(cfg)
    return p


def _ffn(cfg, kind, p, x):
    if _is_moe(cfg, kind):
        return L.moe_apply(cfg, p, x)
    return L.mlp_apply(cfg, p, x)


def _param_shapes(cfg) -> dict:
    """The parameter tree with ``(shape, init kind)`` leaves."""
    d, v = cfg.d_model, cfg.vocab_size
    period_kinds, tail_kinds = block_kinds(cfg)
    n_scan = n_scan_blocks(cfg)

    def stacked(tree, n=n_scan):
        return _map_shapes(lambda shape, kind: ((n,) + shape, kind), tree)

    cross = cfg.is_encoder_decoder
    shapes = {
        "embed": ((v, d), "embed"),
        "layers": tuple(stacked(_block_shapes(cfg, k, cross=cross))
                        for k in period_kinds),
        "tail": tuple(_block_shapes(cfg, k, cross=cross)
                      for k in tail_kinds),
        "final_ln": ((d,), "ones"),
        "unembed": ((d, v), "dense"),
    }
    if cross:
        # the encoder: attention + MLP blocks, stacked encoder_layers deep
        shapes["enc_layers"] = stacked(_block_shapes(cfg, "attn"),
                                       cfg.encoder_layers)
        shapes["enc_ln"] = ((d,), "ones")
    return shapes


def _is_shape_leaf(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[1], str)


def _map_shapes(fn, tree):
    if _is_shape_leaf(tree):
        return fn(*tree)
    if isinstance(tree, dict):
        return {k: _map_shapes(fn, v) for k, v in tree.items()}
    return tuple(_map_shapes(fn, v) for v in tree)


# std of the normal init kinds that do not scale with fan-in
_INIT_STD = {"embed": 1.0, "gate": 1.0, "conv": 0.5}
# a normal leaf of more elements is drawn slice by slice along its
# leading dim, so that the float32 draw of a full-width expert stack
# (arctic_480b: 8.9 B elements a layer pair) never exists whole
_DRAW_CHUNK = 1 << 30


def init_params(cfg, generator: torch.Generator, device=None):
    """Random parameters, drawn from ``generator``.

    Dense weights are normal with std ``1/sqrt(fan_in)`` (the embedding
    and the RG-LRU gate weights std 1, its conv weights std 0.5), the
    RG-LRU ``lam`` uniform in [4, 6), norms one, biases zero, as in the
    reference; the numbers differ from the reference's, which draws from
    ``jax.random``.  A leaf of more than 2**30 elements is drawn slice by
    slice along its leading dim.

    Args:
        cfg: the model configuration.
        generator: the ``torch.Generator`` to draw from; it must live on
            ``device``.
        device: where the parameters live (``None``: the CUDA card).

    Returns:
        The parameter tree.
    """
    dev = resolve_device(device)

    def make(shape, kind):
        if kind == "ones":
            return torch.ones(shape, dtype=cfg.dtype, device=dev)
        if kind == "zeros":
            return torch.zeros(shape, dtype=cfg.dtype, device=dev)
        if kind == "lam":
            u = torch.rand(shape, generator=generator, dtype=torch.float32,
                           device=dev)
            return (u * 2 + 4).to(cfg.dtype)
        scale = _INIT_STD.get(kind) or 1.0 / math.sqrt(L.dense_fan_in(shape))
        return draw(shape, scale)

    def draw(shape, scale):
        if math.prod(shape) > _DRAW_CHUNK and len(shape) > 1:
            out = torch.empty(shape, dtype=cfg.dtype, device=dev)
            for i in range(shape[0]):
                out[i] = draw(shape[1:], scale)
            return out
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return (w * scale).to(cfg.dtype)

    return _map_shapes(make, _param_shapes(cfg))


def param_specs(cfg):
    """The parameter tree as ``meta`` tensors (nothing is allocated)."""
    return _map_shapes(
        lambda shape, kind: torch.empty(shape, dtype=cfg.dtype,
                                        device="meta"),
        _param_shapes(cfg))


def params_from_numpy(tree, device=None):
    """Carry a parameter tree of numpy arrays (e.g. the reference
    package's parameters) into the port.

    Args:
        tree: the parameter tree with array-like leaves; bfloat16 arrays
            are carried exactly through float32.
        device: where the tensors live (``None``: the CUDA card).

    Returns:
        The same tree with torch tensors of the same dtypes.
    """
    dev = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(
                dev, torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(dev)

    return pytree.tree_map(leaf, tree)


def param_logical_axes(cfg, params):
    """Logical dim names for every param leaf (for TOAST's logical
    projection).  Disambiguates key collisions (attention ``wo`` vs MLP
    ``wo``) by the parent block key, a mix ``wo`` whose rows are the RNN
    width (RG-LRU) from an attention one, and the MoE router ``wg`` by
    its expert-count columns; ``experts`` names the expert-count dim of
    the stacked expert weights only."""

    def names(keys, leaf):
        key = keys[-1]
        parent = next((k for k in reversed(keys[:-1])
                       if k in ("mix", "ffn", "cross")), "")
        e = cfg.num_experts
        base = None
        if key == "embed":
            base = ("vocab", "embed")
        elif key == "unembed":
            base = ("embed", "vocab")
        elif key == "wq" or (key == "W" and parent == "mix"):
            base = ("embed", "heads")
        elif key in ("wk", "wv"):
            base = ("embed", "kv_heads")
        elif key == "R":
            base = ("heads", None, None)
        elif key in ("wx", "wy"):
            base = ("embed", "rnn")
        elif key in ("ga_w", "ga_b", "gi_w", "gi_b", "lam", "conv_b"):
            base = ("rnn",)
        elif key == "conv_w":
            base = (None, "rnn")
        elif key in ("wi", "wf") and parent == "mix":   # mLSTM gates
            base = ("embed", "heads")
        elif key == "wo" and parent == "mix":
            base = ("rnn", "embed") if leaf.shape[-2] == L.rnn_width(cfg) \
                else ("heads", "embed")
        elif key == "wg" and e and leaf.shape[-1] == e:
            base = ("embed", "experts")                  # MoE router
        elif key in ("wi", "wg", "wgate", "dense_wi", "dense_wg"):
            base = ("embed", "hidden")
        elif key in ("wo", "dense_wo"):
            base = ("hidden", "embed")
        if base is None:
            return (None,) * leaf.ndim
        extra = leaf.ndim - len(base)
        if extra < 0:
            return tuple(base[-leaf.ndim:])
        # MoE expert stacking: "experts" on the expert-count dim, the
        # first of the leading dims of that size (after the layer dim
        # when there are two)
        prefix = [None] * extra
        if e and key in ("wi", "wgate", "wo") and parent == "ffn":
            for i in range(extra):
                if leaf.shape[i] == e and (extra == 1 or i > 0):
                    prefix[i] = "experts"
                    break
        return tuple(prefix) + base

    return pytree.tree_map_with_path(names, params)


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------


def apply_block(cfg, kind, p, x, positions, *, enc_out=None):
    """One layer, full sequence; ``enc_out``: the encoder's output, which
    a decoder block's cross-attention attends to."""
    # an MoE block places its own weights (layers.moe_apply)
    p = {k: v if k == "ffn" and _is_moe(cfg, kind) else gather_for(v, x)
         for k, v in p.items()}
    if kind == "rglru":
        x = L.rglru_apply(cfg, p["mix"], x)
    elif kind == "mlstm":
        x = L.mlstm_apply(cfg, p["mix"], x)
    elif kind == "slstm":
        x = L.slstm_apply(cfg, p["mix"], x)
    else:
        window = cfg.sliding_window if kind == "attn" else cfg.local_window
        x = L.attn_apply(cfg, p["mix"], x, positions, window=window)
    if "cross" in p and enc_out is not None:
        x = L.attn_apply(cfg, p["cross"], x, positions, enc_out=enc_out)
    if "ffn" in p:
        x = _ffn(cfg, kind, p["ffn"], x)
    return x


def scan_layers(body, h, xs, *, with_ys=False, remat=False):
    """``h = body(h, xs[i])`` for every ``i`` along xs' leading dim.

    With ``with_ys`` the body returns ``(h, y)`` and the result is
    ``(h, ys)``, every leaf of the ``y``s stacked along a new leading
    dim, as ``lax.scan`` returns them.

    Under ``torch.export`` this is one ``scan`` node whose body is
    traced once; eagerly it is a loop.  Each iteration runs under the
    same kernel-dispatch site keys, those of the body's one traced
    instance, so a plan's per-site decisions apply to every layer.

    With ``remat`` and gradients enabled, each eager iteration runs
    under ``torch.utils.checkpoint`` (non-reentrant): the backward
    recomputes the body.  The recomputations run under the site keys
    that follow the whole forward's (the tail layers' included), as the
    traced train program holds the recomputed body in the backward
    scan, after every forward site (``core.autodiff``).  On a mesh (a
    dispatch carrying one) they run under the forward's own site keys
    instead: a recomputed site must see the blocks its forward saw
    (``torch.utils.checkpoint`` holds the recomputed tensors to the
    forward's shapes), and another site's specs may split it otherwise.
    """
    step = body if with_ys else (lambda c, x: (body(c, x), ()))
    if torch.compiler.is_exporting():
        from torch._higher_order_ops.scan import scan
        h, ys = scan(step, h, xs)
        return (h, ys) if with_ys else h
    n = pytree.tree_leaves(xs)[0].shape[0]
    disp = get_kernel_dispatch()
    mark = disp.mark() if disp is not None else None
    rules = get_rules()
    run = step
    if remat and torch.is_grad_enabled():
        # the body rewinds to marks[0] in the forward pass; after the
        # loop a None stands for the counters at the forward's end, read
        # when the backward first recomputes the body, and every
        # recomputation rewinds to them
        marks = [mark]

        def rewound(c, x):
            # the recomputation runs on autograd's thread (its own for
            # CUDA tensors): install the forward's dispatch and logical
            # rules there
            with kernel_dispatch(disp, reset=False), logical_rules(rules):
                if disp is not None:
                    if marks[-1] is None:
                        marks[-1] = disp.mark()
                    disp.rewind(marks[-1] if disp.mesh is None else marks[0])
                return step(c, x)

        def run(c, x):
            from torch.utils.checkpoint import checkpoint
            # the body draws no random numbers; saving and restoring the
            # CUDA RNG state would not be capturable in a CUDA graph
            return checkpoint(rewound, c, x, use_reentrant=False,
                              preserve_rng_state=False)
    ys = []
    for i in range(n):
        if disp is not None:
            disp.rewind(mark)
        h, y = run(h, pytree.tree_map(lambda a: layer(a, i), xs))
        ys.append(y)
    if run is not step and disp is not None:
        marks.append(None)
    if not with_ys:
        return h
    stacked = [torch.stack(col) for col in
               zip(*(pytree.tree_leaves(y) for y in ys))]
    return h, pytree.unflatten(ys[0], stacked)


def _run_layers(cfg, params, h, positions, *, enc_out=None):
    period_kinds, tail_kinds = block_kinds(cfg)

    # the body closes over enc_out: a const of the layer scan
    def super_block(h, pslices):
        for kind, p in zip(period_kinds, pslices):
            h = apply_block(cfg, kind, p, h, positions, enc_out=enc_out)
        return constrain(h, ("act_batch", "seq", "embed"))

    if n_scan_blocks(cfg) > 0 and params["layers"]:
        h = scan_layers(super_block, h, params["layers"], remat=cfg.remat)
    for kind, p in zip(tail_kinds, params["tail"]):
        h = apply_block(cfg, kind, p, h, positions, enc_out=enc_out)
    return h


def encode(cfg, params, frames):
    """The encoder over precomputed frame embeddings (the reference's
    stub frontend): frames (B, S_enc, D) of any float dtype, cast to the
    config's; each ``enc_layers`` block non-causal self-attention then
    the MLP, in its own layer scan; ``enc_ln`` last.

    Returns:
        (B, S_enc, D) in the config's dtype.
    """
    S = frames.shape[1]
    h = frames.to(cfg.dtype)
    positions = replicate_like(torch.arange(S, dtype=torch.int32,
                                            device=frames.device)[None, :], h)

    def enc_block(h, p):
        h = L.attn_apply(cfg, p["mix"], h, positions, is_causal=False)
        return L.mlp_apply(cfg, p["ffn"], h)

    h = scan_layers(enc_block, h, params["enc_layers"], remat=cfg.remat)
    return L.rmsnorm(h, params["enc_ln"])


def embed_tokens(cfg, params, tokens):
    h = embedding(tokens, params["embed"])
    # the scale rounded to the activations' dtype, as the reference does
    return h * L.round_to(h.dtype, math.sqrt(cfg.d_model))


def forward(cfg, params, tokens, *, patch_embeds=None, frames=None):
    """Logits for a full sequence (train / prefill).

    Args:
        cfg: the model configuration.
        params: the parameter tree.
        tokens: (B, S) int token ids.
        patch_embeds: (B, P, D) precomputed patch embeddings of a vision
            model, placed before the tokens (cast to their dtype).
        frames: (B, S_enc, D) precomputed frame embeddings of an
            encoder-decoder model, run through :func:`encode`.

    Returns:
        (B, P + S, vocab) logits.
    """
    enc_out = encode(cfg, params, frames) if frames is not None else None
    h = embed_tokens(cfg, params, tokens)
    if patch_embeds is not None:
        h = cat_like([patch_embeds.to(h.dtype), h], 1, h)
    h = constrain(h, ("act_batch", "seq", "embed"))
    S = h.shape[1]
    positions = replicate_like(torch.arange(S, dtype=torch.int32,
                                            device=tokens.device)[None, :], h)
    h = _run_layers(cfg, params, h, positions, enc_out=enc_out)
    h = L.rmsnorm(h, params["final_ln"])
    logits = matmul(h, gather_for(params["unembed"], h))
    if cfg.logits_vocab_shard:
        # one mesh axis shards one dim of a tensor: vocab rather than seq
        # here, as the reference prefers for large vocabularies
        return constrain(logits, ("act_batch", None, "vocab"))
    return constrain(logits, ("act_batch", "seq", "vocab"))


# ---------------------------------------------------------------------------
# decode (KV / recurrent caches)
# ---------------------------------------------------------------------------


def _block_cache(cfg, kind, batch, max_seq, device):
    if kind == "rglru":
        return L.rglru_init_cache(cfg, batch, device=device)
    if kind == "mlstm":
        return L.mlstm_init_cache(cfg, batch, device=device)
    if kind == "slstm":
        return L.slstm_init_cache(cfg, batch, device=device)
    window = cfg.sliding_window if kind == "attn" else cfg.local_window
    return L.attn_init_cache(cfg, batch, max_seq, window, device=device)


def init_cache(cfg, batch, max_seq, device=None):
    """The empty decode cache, in the reference's layout.

    Args:
        cfg: the model configuration.
        batch: the decode batch size.
        max_seq: the cache depth (prompt plus generated tokens); a
            windowed attention block keeps ``min(window, max_seq)``
            slots.
        device: where the cache lives (``None``: the CUDA card;
            ``"meta"``: shapes only, as the reference's
            ``jax.eval_shape``).

    Returns:
        ``{"layers": ..., "tail": ...}``: per kind of the pattern's
        period, its block cache stacked ``n_scan_blocks`` deep; per tail
        layer, its block cache.
    """
    dev = resolve_device(device)
    period_kinds, tail_kinds = block_kinds(cfg)
    n_scan = n_scan_blocks(cfg)

    def stack(tree):
        return pytree.tree_map(
            lambda x: x.expand((n_scan,) + tuple(x.shape)).clone(), tree)

    return {
        "layers": tuple(stack(_block_cache(cfg, k, batch, max_seq, dev))
                        for k in period_kinds),
        "tail": tuple(_block_cache(cfg, k, batch, max_seq, dev)
                      for k in tail_kinds),
    }


def decode_block(cfg, kind, p, x, cache, pos, *, enc_out=None):
    """One layer's one-token decode; returns ``(x, new cache)``.  With
    ``enc_out``, a decoder block's cross-attention attends to it (its
    keys and values projected anew; it keeps no cache)."""
    if kind == "rglru":
        x, cache = L.rglru_decode(cfg, p["mix"], x, cache, pos)
    elif kind == "mlstm":
        x, cache = L.mlstm_decode(cfg, p["mix"], x, cache, pos)
    elif kind == "slstm":
        x, cache = L.slstm_decode(cfg, p["mix"], x, cache, pos)
    else:
        window = cfg.sliding_window if kind == "attn" else cfg.local_window
        x, cache = L.attn_decode(cfg, p["mix"], x, cache, pos,
                                 window=window)
    if "cross" in p and enc_out is not None:
        x, _ = L.attn_decode(cfg, p["cross"], x, None, pos, enc_out=enc_out)
    if "ffn" in p:
        x = _ffn(cfg, kind, p["ffn"], x)
    return x, cache


def decode_step(cfg, params, cache, token, pos, *, enc_out=None):
    """One autoregressive step.

    Args:
        cfg: the model configuration.
        params: the parameter tree.
        cache: the cache tree of :func:`init_cache`.
        token: (B, 1) int token ids.
        pos: the token's position, a 0-d int32 tensor (a traced input
            under ``torch.export``, never read on the host).
        enc_out: an encoder-decoder model's (B, S_enc, D) encoder
            output (:func:`encode`), which every decoder block's
            cross-attention reads.

    Returns:
        ``(logits (B, 1, vocab), new cache)``; ``cache`` is not written.
    """
    period_kinds, tail_kinds = block_kinds(cfg)
    h = embed_tokens(cfg, params, token)
    h = constrain(h, ("act_batch", None, "embed"))

    def body(h, xs):
        pslices, cslices = xs
        new_c = []
        for kind, p, c in zip(period_kinds, pslices, cslices):
            h, c2 = decode_block(cfg, kind, p, h, c, pos, enc_out=enc_out)
            new_c.append(c2)
        return h, tuple(new_c)

    if n_scan_blocks(cfg) > 0 and params["layers"]:
        h, new_layer_cache = scan_layers(
            body, h, (params["layers"], cache["layers"]), with_ys=True)
    else:
        new_layer_cache = cache["layers"]
    new_tail = []
    for kind, p, c in zip(tail_kinds, params["tail"], cache["tail"]):
        h, c2 = decode_block(cfg, kind, p, h, c, pos, enc_out=enc_out)
        new_tail.append(c2)
    h = L.rmsnorm(h, params["final_ln"])
    logits = matmul(h, params["unembed"])
    return logits, {"layers": new_layer_cache, "tail": tuple(new_tail)}
