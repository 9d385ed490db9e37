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


def reference_attention_bwd(q, k, v, do, *, causal: bool = True,
                            sm_scale: float | None = None):
    """The vjp of :func:`reference_attention`, written out.

    q (B,H,S,hd); k, v (B,H,T,hd); ``do`` the output's cotangent, in
    q's layout.  The softmax's vjp is taken in float32 from the
    recomputed probabilities; each cotangent leaves in its input's
    dtype, as the reference package's ``jax.vjp`` of its plain
    attention gives them.

    Returns:
        ``(dq, dk, dv)``.
    """
    hd = q.shape[-1]
    sm_scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(hd)
    s = torch.einsum("bhsd,bhtd->bhst", q, k).to(torch.float32) * sm_scale
    mask = None
    if causal:
        S, T = s.shape[-2:]
        mask = torch.arange(S, device=s.device)[:, None] >= \
            torch.arange(T, device=s.device)[None, :]
        s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    dv = torch.einsum("bhst,bhsd->bhtd", p.to(v.dtype), do)
    dp = torch.einsum("bhsd,bhtd->bhst", do, v).to(torch.float32)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    if mask is not None:
        ds = torch.where(mask, ds, 0.0)
    ds = (ds * sm_scale).to(q.dtype)
    dq = torch.einsum("bhst,bhtd->bhsd", ds, k)
    dk = torch.einsum("bhst,bhsd->bhtd", ds, q)
    return dq, dk, dv


def _lru_combine(a1, b1, a2, b2):
    # (a1, b1) then (a2, b2): h -> a2 (a1 h + b1) + b2
    return a1 * a2, a2 * b1 + b2


def _interleave(x, y):
    """x at the even and y at the odd positions of dim 1, as
    ``lax.pad`` with interior padding 1 builds them (one ``slice_scatter``
    into zeros each, which the tracer lowers to that ``pad``)."""
    shape = (x.shape[0], x.shape[1] + y.shape[1], *x.shape[2:])
    return torch.slice_scatter(x.new_zeros(shape), x, 1, 0, None, 2) + \
        torch.slice_scatter(y.new_zeros(shape), y, 1, 1, None, 2)


def lru_associative_scan(a, b):
    """Inclusive scan of ``(a, b)`` pairs along dim 1 under the linear
    recurrence's combine, by the odd/even recursion of
    ``jax.lax.associative_scan``, step for step: the same slices,
    products, concatenations and pads, so the traced program has the
    reference's structure.

    Returns:
        ``(prod a, h)`` with ``h_t = a_t h_{t-1} + b_t`` from h = 0.
    """
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _lru_combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2],
                          b[:, 1::2])
    oa, ob = lru_associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _lru_combine(oa[:, 0:-1], ob[:, 0:-1], a[:, 2::2],
                              b[:, 2::2])
    else:
        ea, eb = _lru_combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, 0:1], ea], 1)
    eb = torch.cat([b[:, 0:1], eb], 1)
    return _interleave(ea, oa), _interleave(eb, ob)


def reference_rg_lru(a, b):
    """The linear recurrence, plainly: a, b (B,S,R) -> h (B,S,R).

    ``h_t = a_t h_{t-1} + b_t`` from h = 0, computed in float32 by the
    associative scan and returned in a's dtype.  This is the plain
    version of the CUDA RG-LRU kernel (``kernels/rg_lru.py``).
    """
    _, h = lru_associative_scan(a.to(torch.float32), b.to(torch.float32))
    return h.to(a.dtype)


def reference_rg_lru_bwd(a, b, dh):
    """The vjp of :func:`reference_rg_lru`, written out.

    With ``h`` recomputed from ``(a, b)``, the cotangent of ``h_t`` that
    reaches step t is ``g_t = dh_t + a_{t+1} g_{t+1}``: the same linear
    recurrence run backwards in time (the associative scan of the
    reversed inputs).  Then ``db = g`` and ``da_t = g_t h_{t-1}`` with
    ``h_{-1} = 0``.  Computed in float32; each cotangent leaves in its
    input's dtype, as the reference package's ``jax.vjp`` of its plain
    scan gives them.

    Args:
        a: decay gates (B,S,R).
        b: inputs, a's shape.
        dh: the cotangent of the result, a's shape.

    Returns:
        ``(da, db)``.
    """
    af, bf = a.to(torch.float32), b.to(torch.float32)
    _, h = lru_associative_scan(af, bf)
    # a_{t+1}, zero past the end; both reversed in time for the scan
    a_next = torch.cat([af[:, 1:], torch.zeros_like(af[:, :1])], 1)
    _, g = lru_associative_scan(a_next.flip(1),
                                dh.to(torch.float32).flip(1))
    g = g.flip(1)
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], 1)
    return (g * h_prev).to(a.dtype), g.to(b.dtype)
