"""Static metadata for every fused kernel the tracer can record.

The port's copy of the *fused-op IR contract*: which kernels exist, the
dimension **roles** of their operands/results (how NDA colors propagate
through the fused op), which roles a sharding may map over the mesh vs
which are consumed *inside* the kernel and must never be sharded, the
available implementations, and per-impl roofline formulas (FLOPs / HBM
bytes) the cost model prices kernel sites with.

Implementations: ``"cuda"`` is the hand-written kernel for Hopper
(``kernels/csrc``), ``"ref"`` its plain PyTorch version.  A reference
plan's ``"pallas"`` decisions read as ``"cuda"`` (:func:`port_impl`).

Deliberately **pure python** — no torch imports — so ``core.nda``,
``core.actions`` and ``core.cost_model`` can consume it without pulling
accelerator code into the analysis layer.
"""

from __future__ import annotations

import dataclasses
import math

__all__ = [
    "BLOCK_Q", "CUDA_HEAD_DIMS", "KERNEL_PRIM_PREFIX", "KERNELS",
    "KernelSpec", "cuda_feasible", "kernel_name", "port_impl",
    "spec_for_prim",
]

# IR prims for fused kernel sites are f"{KERNEL_PRIM_PREFIX}{name}"
KERNEL_PRIM_PREFIX = "kernel:"

# query rows one thread block of the CUDA flash-attention kernel's bf16
# path owns (``kBlockQ`` in ``csrc/flash_attention.cu``); K/V are
# streamed once per such block.  The f32 path, off the main path, owns 64.
BLOCK_Q = 128

# head dims the CUDA flash-attention kernel is instantiated for.  It masks
# ragged sequence edges itself, so head_dim is its only shape limit.
CUDA_HEAD_DIMS = frozenset(range(16, 129, 16))

# impl names of the reference package that mean the same implementation
# here (its Pallas TPU kernel's counterpart is the CUDA kernel)
_IMPL_ALIASES = {"pallas": "cuda"}


def port_impl(impl: str) -> str:
    """The port's name for an impl recorded by the reference package."""
    return _IMPL_ALIASES.get(impl, impl)


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Contract of one fused kernel as seen by the analysis stack.

    Attributes:
        name: kernel id (``flash_attention``, ``rg_lru``, ...).
        operand_roles: per-operand dim-role names; equal role names are
            unified by the NDA (they must shard identically).
        result_roles: per-result dim-role names, same role namespace.
        mappable: roles a plan may shard — the site runs per device over
            exactly these roles' mesh axes.
        blocked: roles consumed inside the kernel (contractions, the
            scan axis, the head dim); sharding them is excluded from the
            action space while kernel sites are present.
        impls: available implementations, preferred first.  Sites with
            a single impl contribute no search decision.
        head_dim_role: role whose size must be one of
            :data:`CUDA_HEAD_DIMS` for the ``"cuda"`` impl (``None``: no
            shape limit).
        dispatch_site: True for kernels called through a ``kernels.ops``
            entry point (they allocate a per-trace dispatch site key);
            False for backward kernels, which inherit the entry kernel's
            site.
    """

    name: str
    operand_roles: tuple[tuple[str, ...], ...]
    result_roles: tuple[tuple[str, ...], ...]
    mappable: frozenset
    blocked: frozenset
    impls: tuple[str, ...]
    head_dim_role: str | None = None
    dispatch_site: bool = True

    @property
    def prim(self) -> str:
        """The IR prim this kernel traces as (``kernel:<name>``)."""
        return KERNEL_PRIM_PREFIX + self.name

    @property
    def default_impl(self) -> str:
        """The impl assumed when a state records no explicit choice."""
        return self.impls[0]

    def dims_from_shapes(self, shapes) -> dict:
        """Map role -> size from per-operand shapes (first occurrence).

        Args:
            shapes: one shape tuple per operand, model layout.

        Returns:
            ``{role: size}`` for every operand role.
        """
        dims: dict = {}
        for roles, shape in zip(self.operand_roles, shapes):
            for role, size in zip(roles, shape):
                dims.setdefault(role, int(size))
        return dims

    def flops(self, dims: dict, params: dict) -> float:
        """Model FLOPs of one call given role sizes ``dims``."""
        return _FLOPS[self.name](dims, params)

    def bytes_moved(self, impl: str, dims: dict, params: dict,
                    dtype_bytes: int) -> float:
        """Modelled HBM traffic of one call for implementation ``impl``."""
        return _BYTES[self.name](impl, dims, params, dtype_bytes)

    def feasible(self, impl: str, dims: dict) -> bool:
        """Whether ``impl`` can run on role sizes ``dims``.

        The reference impl always can; the CUDA kernel masks ragged
        sequence tiles itself, so only its head dim limits it.
        """
        if impl != "cuda" or self.head_dim_role is None:
            return True
        n = dims.get(self.head_dim_role)
        return n is None or n in CUDA_HEAD_DIMS


# -- per-kernel roofline formulas -------------------------------------------
#
# dims use the role names of the specs below.  Formulas are intentionally
# simple analytic models.


def _fa_flops(d, params):
    # two matmuls (QK^T and PV) over the full score matrix; causal
    # self-attention touches half the blocks
    f = 4.0 * d["batch"] * d["heads"] * d["q_seq"] * d["kv_seq"] * \
        d["head_dim"]
    if params.get("causal") and d["q_seq"] == d["kv_seq"]:
        f *= 0.5
    return f


def _fa_bytes(impl, d, params, db):
    io = d["batch"] * d["heads"] * d["head_dim"] * \
        (2.0 * d["q_seq"] + 2.0 * d["kv_seq"]) * db
    if impl == "cuda":
        # flash streaming: Q and O once; K/V re-read once per q-block
        nq = max(1, -(-d["q_seq"] // BLOCK_Q))
        return d["batch"] * d["heads"] * d["head_dim"] * db * (
            2.0 * d["q_seq"] + 2.0 * d["kv_seq"] * nq)
    # reference: materializes the f32 score matrix (write+read, twice —
    # scores then softmax probabilities)
    scores = 4.0 * d["batch"] * d["heads"] * d["q_seq"] * d["kv_seq"] * 4
    return io + scores


def _fa_bwd_flops(d, params):
    # 5 matmuls in the attention backward vs 2 forward
    return 2.5 * _fa_flops(d, params)


def _fa_bwd_bytes(impl, d, params, db):
    io = d["batch"] * d["heads"] * d["head_dim"] * \
        (4.0 * d["q_seq"] + 4.0 * d["kv_seq"]) * db
    scores = 8.0 * d["batch"] * d["heads"] * d["q_seq"] * d["kv_seq"] * 4
    return io + scores


def _lru_flops(d, params):
    return 2.0 * d["batch"] * d["seq"] * d["channels"]


def _lru_bytes(impl, d, params, db):
    elems = d["batch"] * d["seq"] * d["channels"]
    if impl == "cuda":
        # single pass: read a, b; write h
        return 3.0 * elems * db
    # associative scan: log2(S) combine passes, each reading and
    # writing both carry arrays
    passes = max(1.0, math.ceil(math.log2(max(d["seq"], 2))))
    return 4.0 * elems * db * passes


def _lru_bwd_flops(d, params):
    return 4.0 * d["batch"] * d["seq"] * d["channels"]


def _lru_bwd_bytes(impl, d, params, db):
    passes = max(1.0, math.ceil(math.log2(max(d["seq"], 2))))
    return 6.0 * d["batch"] * d["seq"] * d["channels"] * db * passes


_FLOPS = {
    "flash_attention": _fa_flops,
    "flash_attention_bwd": _fa_bwd_flops,
    "rg_lru": _lru_flops,
    "rg_lru_bwd": _lru_bwd_flops,
}

_BYTES = {
    "flash_attention": _fa_bytes,
    "flash_attention_bwd": _fa_bwd_bytes,
    "rg_lru": _lru_bytes,
    "rg_lru_bwd": _lru_bwd_bytes,
}


# -- the registry -----------------------------------------------------------

_ATTN_Q = ("batch", "q_seq", "heads", "head_dim")
_ATTN_KV = ("batch", "kv_seq", "heads", "head_dim")
_LRU = ("batch", "seq", "channels")

KERNELS: dict[str, KernelSpec] = {
    "flash_attention": KernelSpec(
        name="flash_attention",
        # model layout, GQA already expanded by the layer: q (B,S,H,hd);
        # k, v (B,T,H,hd) -> o (B,S,H,hd)
        operand_roles=(_ATTN_Q, _ATTN_KV, _ATTN_KV),
        result_roles=(_ATTN_Q,),
        mappable=frozenset({"batch", "heads"}),
        # kv_seq is the softmax contraction; q_seq tiles the grid with
        # causal masking against absolute positions; head_dim is the
        # contraction of both products — none survive sharding inside
        # the kernel.
        blocked=frozenset({"q_seq", "kv_seq", "head_dim"}),
        impls=("cuda", "ref"),
        head_dim_role="head_dim",
    ),
    "flash_attention_bwd": KernelSpec(
        name="flash_attention_bwd",
        # (q, k, v, d_out) -> (dq, dk, dv)
        operand_roles=(_ATTN_Q, _ATTN_KV, _ATTN_KV, _ATTN_Q),
        result_roles=(_ATTN_Q, _ATTN_KV, _ATTN_KV),
        mappable=frozenset({"batch", "heads"}),
        blocked=frozenset({"q_seq", "kv_seq", "head_dim"}),
        impls=("ref",),
        dispatch_site=False,
    ),
    "rg_lru": KernelSpec(
        name="rg_lru",
        # h_t = a_t * h_{t-1} + b_t over (B, S, R); the CUDA kernel
        # masks ragged channel and sequence edges, so no shape limits it
        operand_roles=(_LRU, _LRU),
        result_roles=(_LRU,),
        mappable=frozenset({"batch", "channels"}),
        blocked=frozenset({"seq"}),
        impls=("cuda", "ref"),
    ),
    "rg_lru_bwd": KernelSpec(
        name="rg_lru_bwd",
        # (a, b, d_out) -> (da, db)
        operand_roles=(_LRU, _LRU, _LRU),
        result_roles=(_LRU, _LRU),
        mappable=frozenset({"batch", "channels"}),
        blocked=frozenset({"seq"}),
        impls=("ref",),
        dispatch_site=False,
    ),
}


def kernel_name(prim: str) -> str | None:
    """The kernel id of an IR prim, or ``None`` for non-kernel prims."""
    if prim.startswith(KERNEL_PRIM_PREFIX):
        return prim[len(KERNEL_PRIM_PREFIX):]
    return None


def spec_for_prim(prim: str) -> KernelSpec | None:
    """Registry lookup by IR prim (``kernel:<name>``)."""
    name = kernel_name(prim)
    return KERNELS.get(name) if name else None


def cuda_feasible(name: str, dims: dict) -> bool:
    """Whether the CUDA impl of ``name`` can run on role sizes ``dims``."""
    spec = KERNELS.get(name)
    return spec is not None and "cuda" in spec.impls and \
        spec.feasible("cuda", dims)
