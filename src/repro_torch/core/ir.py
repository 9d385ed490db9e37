"""Light tensor IR extracted from a ``torch.export`` graph.

The paper's NDA operates on straight-line tensor programs in ANF (SSA).
An exported aten graph is exactly that.  :func:`extract_program` exports
the function on ``meta`` tensors (nothing is allocated, nothing runs)
and lowers every aten node onto the reference package's prim vocabulary
(``dot_general``, ``broadcast_in_dim``, ``reduce_sum``, ``select_n``,
...), so the analysis core (``core.nda`` and everything after it) runs
unchanged on the result:

- ``matmul`` / ``einsum`` become ``dot_general`` (plus a ``transpose``
  to the einsum's output order).  The default decompositions are never
  run: they would merge batch and sequence dims into one ``mm`` and NDA
  could no longer shard them apart.
- Elementwise ops follow the reference's implicit-broadcast convention:
  lower-rank operands are rank-promoted with ``broadcast_in_dim``,
  rank-0 operands and Python scalars stay scalar literals, and operands
  of another dtype are converted first.
- The layer ``scan`` (``torch._higher_order_ops.scan``) is instantiated
  once, with trip counts and carry / ``xs`` / ``ys`` value links, as the
  reference does for ``lax.scan``.
- Constant fills (``zeros``, ``new_zeros``, ``zeros_like``, ``full``)
  are broadcast literals, emitted where they are first used; a
  ``slice_scatter`` into one is the reference's ``pad`` (the associative
  scan's interleave), so the fill itself is never emitted there.
- A chain of ``unsqueeze`` ops is one ``broadcast_in_dim``, as the
  reference's ``x[:, None, None]``.  ``index_copy`` of one slot whose
  index is a scalar made one-element (``slot[None]``) is the reference's
  ``dynamic_update_slice`` at that scalar (the decode caches' ring
  write), so the one-element index itself is never emitted.
- ``repro_torch::top_k`` is the reference's ``top_k`` prim.  A
  ``gather`` or ``scatter_add`` whose operand or index is an ``expand``
  (``layers.take_along_axis``, ``layers.scatter_add_rows``) is lowered
  as ``jnp.take_along_axis`` and the ``vmap``'d ``.at[].add`` lower
  them: one ``gather`` / ``scatter-add`` of the unexpanded tensors (a
  gather's size-1 dims squeezed or taken as offset dims, the others
  batching dims; a scatter's dims before the scattered one batching
  dims, those after it window dims), so the expansion itself is never
  emitted.
- The fused kernel ops (``repro_torch::flash_attention``,
  ``repro_torch::rg_lru``) are each recorded as one ``kernel:<name>``
  op; their impl argument is dropped, so the program does not depend on
  the implementation choice.

An aten op the tracer does not know raises: NDA treats an unknown prim
as elementwise, so a silently passed-through ``view`` or ``mm`` would
give wrong colors without any error.
"""

from __future__ import annotations

import dataclasses
import hashlib
import operator
import re
from typing import NamedTuple

import numpy as np

from repro_torch import pytree
from repro_torch.kernels import registry as kernel_registry

# bytes per element of every dtype a traced program may carry
ITEMSIZE = {
    "bool": 1, "uint8": 1, "int8": 1, "int16": 2, "int32": 4, "int64": 8,
    "float16": 2, "bfloat16": 2, "float32": 4, "float64": 8,
    "complex64": 8, "complex128": 16,
}


def dtype_name(dtype) -> str:
    """The IR's name for a torch (or numpy) dtype, e.g. ``"bfloat16"``."""
    name = str(dtype).removeprefix("torch.")
    if name not in ITEMSIZE:
        name = np.dtype(dtype).name
    if name not in ITEMSIZE:
        raise TypeError(f"dtype {dtype} has no entry in the IR's "
                        f"itemsize table")
    return name


@dataclasses.dataclass(frozen=True)
class TensorType:
    shape: tuple[int, ...]
    dtype: str                   # a key of ITEMSIZE

    def __post_init__(self) -> None:
        # size/nbytes sit on the cost model's per-row hot path (millions
        # of reads per search); precompute once
        size = 1
        for s in self.shape:
            size *= int(s)
        object.__setattr__(self, "_size", size)
        object.__setattr__(self, "_nbytes", size * ITEMSIZE[self.dtype])

    @property
    def rank(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return self._size

    @property
    def nbytes(self) -> int:
        return self._nbytes


@dataclasses.dataclass
class Op:
    prim: str
    params: dict
    operands: list[int]          # value ids
    results: list[int]           # value ids
    # For scan-instantiated ops, records which structural role each
    # operand/result plays; used by nda to add loop-carried identities.
    meta: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Program:
    ops: list[Op] = dataclasses.field(default_factory=list)
    types: dict[int, TensorType] = dataclasses.field(default_factory=dict)
    inputs: list[int] = dataclasses.field(default_factory=list)
    outputs: list[int] = dataclasses.field(default_factory=list)
    input_paths: list[str] = dataclasses.field(default_factory=list)
    # extra identity links between values: (vid_a, vid_b, offset_a) means
    # dims[offset_a:] of a are identified dim-wise with dims of b.  Produced
    # by scan carry connections (offset 0) and scan xs/ys slicing (offset 1).
    value_links: list[tuple[int, int, int]] = dataclasses.field(default_factory=list)
    # number of loop iterations each op executes (1 for top level,
    # `length` for ops inside a scan body) — used by the cost model.
    trip_counts: dict[int, int] = dataclasses.field(default_factory=dict)
    # the next value id (values dropped by dead-code elimination leave
    # their ids unused)
    next_vid: int = 0

    def new_value(self, shape, dtype) -> int:
        vid = max(len(self.types), self.next_vid)
        self.next_vid = vid + 1
        self.types[vid] = TensorType(tuple(int(s) for s in shape),
                                     dtype_name(dtype))
        return vid

    def add_op(self, op: Op, trip: int = 1) -> None:
        self.trip_counts[len(self.ops)] = trip
        self.ops.append(op)


class GatherDimensionNumbers(NamedTuple):
    """The gather dimension numbers ``core.nda``'s gather rule reads."""

    offset_dims: tuple[int, ...]
    collapsed_slice_dims: tuple[int, ...]
    start_index_map: tuple[int, ...]
    operand_batching_dims: tuple[int, ...] = ()
    start_indices_batching_dims: tuple[int, ...] = ()


class ScatterDimensionNumbers(NamedTuple):
    """The scatter dimension numbers ``core.nda``'s scatter rule reads."""

    update_window_dims: tuple[int, ...]
    inserted_window_dims: tuple[int, ...]
    scatter_dims_to_operand_dims: tuple[int, ...]
    operand_batching_dims: tuple[int, ...] = ()
    scatter_indices_batching_dims: tuple[int, ...] = ()


class UnsupportedOpError(NotImplementedError):
    """An exported node the tracer has no lowering for."""


@dataclasses.dataclass(frozen=True)
class _Ref:
    """A traced value inside the node environment (vs a Python scalar)."""

    vid: int


@dataclasses.dataclass(eq=False)
class _Fill:
    """A constant-filled tensor, not emitted until it is used: a
    ``slice_scatter`` into it becomes a ``pad``, any other use emits it
    once as a broadcast literal (``vid``)."""

    shape: tuple[int, ...]
    dtype: str
    vid: int | None = None


@dataclasses.dataclass(frozen=True)
class _Unsqueezed:
    """An ``unsqueeze`` whose only user is another ``unsqueeze``: not
    emitted, so the chain becomes one ``broadcast_in_dim`` of ``vid``."""

    vid: int
    bdims: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class _Expanded:
    """An ``expand`` of ``vid`` to ``shape`` whose every user takes it as
    a ``gather`` operand or index, or a ``scatter_add`` index: not
    emitted, the user broadcasts as the reference's indexing does."""

    vid: int
    shape: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class _SlotIndex:
    """A scalar made one-element (``slot[None]``) whose every user takes
    it as ``index_copy``'s index: the scalar ``vid`` is the start of the
    reference's ``dynamic_update_slice``."""

    vid: int


# aten op -> prim for ops whose NDA rule is the elementwise default
_ARITH = {
    "add": "add", "sub": "sub", "mul": "mul", "div": "div",
    "exp": "exp", "rsqrt": "rsqrt", "cos": "cos", "sin": "sin",
    "neg": "neg", "tanh": "tanh", "sigmoid": "logistic", "sqrt": "sqrt",
    "abs": "abs", "log1p": "log1p", "maximum": "max", "clamp_min": "max",
    "remainder": "rem", "log": "log", "square": "square",
    "minimum": "min",
}
_COMPARE = {"ge": "ge", "lt": "lt", "le": "le", "eq": "eq", "ne": "ne",
            "bitwise_and": "and", "__and__": "and", "isfinite": "is_finite"}
# ops whose lowering takes some arguments unemitted (see _ready)
_LAZY_ARGS = frozenset({"slice_scatter", "unsqueeze", "index_copy"})
# constant fills (a literal's value is not part of the IR)
_FILLS = frozenset({"zeros", "new_zeros", "zeros_like", "full", "ones"})
# nodes that compute nothing the analysis can see
_IGNORED = {"_assert_tensor_metadata"}
# the train step's gradient node (``train.steps``) and ``lax.top_k``
# (``models.layers``); every other op of the namespace is a fused kernel
_GRAD_OP = "grad"
_TOP_K_OP = "top_k"
# the users that take an expand's operand unexpanded: (op, argument)
_EXPAND_USERS = frozenset({("gather", 0), ("gather", 2),
                           ("scatter_add", 2)})

_KERNEL_NAMESPACE = "repro_torch"


def _norm_dim(d: int, rank: int) -> int:
    return d + rank if d < 0 else d


def _packet(node) -> str | None:
    """The aten overload packet's name of an exported node's target."""
    return getattr(getattr(node.target, "_overloadpacket", None),
                   "__name__", None)


def _meta(node) -> tuple[tuple[int, ...], str]:
    """Static ``(shape, dtype name)`` of an exported node's value."""
    val = node.meta.get("val")
    if val is None or not hasattr(val, "shape"):
        raise UnsupportedOpError(f"node {node.name} carries no tensor value")
    try:
        shape = tuple(int(s) for s in val.shape)
    except TypeError:
        raise UnsupportedOpError(
            f"node {node.name} has a symbolic shape {tuple(val.shape)}; "
            f"trace with static shapes") from None
    return shape, dtype_name(val.dtype)


class _Extractor:
    def __init__(self) -> None:
        self.prog = Program()
        self.trip = 1
        # top-level scans so far (``autodiff.ScanRecord``, nested ones
        # in their parents' ``children``) and detached
        # values, read when a gradient node is lowered
        self.scans: list = []
        self.stopped: set[int] = set()
        # the node environments of the graphs being walked (a scan body's
        # inside its parent's)
        self._envs: list[dict] = []
        # per scan body being walked, the scans recorded in it so far
        self._open: list[list] = []

    # -- value plumbing ---------------------------------------------------

    def _emit(self, prim: str, params: dict, operands: list[int],
              shape, dtype) -> int:
        vid = self.prog.new_value(shape, dtype)
        self.prog.add_op(Op(prim, params, list(operands), [vid]), self.trip)
        return vid

    def _literal(self, dtype) -> int:
        """A scalar constant: a value with no defining op."""
        return self.prog.new_value((), dtype)

    def _type(self, vid: int) -> TensorType:
        return self.prog.types[vid]

    def _convert(self, vid: int, dtype: str) -> int:
        if self._type(vid).dtype == dtype:
            return vid
        return self._emit("convert_element_type",
                          {"new_dtype": dtype, "weak_type": False},
                          [vid], self._type(vid).shape, dtype)

    def _bcast(self, vid: int, shape: tuple[int, ...],
               bdims: tuple[int, ...]) -> int:
        return self._emit("broadcast_in_dim",
                          {"shape": tuple(shape),
                           "broadcast_dimensions": tuple(bdims)},
                          [vid], shape, self._type(vid).dtype)

    def _ready(self, x):
        """``x`` with every :class:`_Fill` in it emitted as a ``_Ref``."""
        if isinstance(x, _Fill):
            if x.vid is None:
                x.vid = self._bcast(self._literal(x.dtype), x.shape, ())
            return _Ref(x.vid)
        if isinstance(x, (list, tuple)):
            return type(x)(self._ready(e) for e in x)
        if isinstance(x, dict):
            return {k: self._ready(v) for k, v in x.items()}
        return x

    def _rank_promote(self, vid: int, rank: int) -> int:
        t = self._type(vid)
        if t.rank == 0 or t.rank == rank:
            return vid
        k = rank - t.rank
        return self._bcast(vid, (1,) * k + t.shape,
                           tuple(range(k, rank)))

    def _bcast_to(self, vid: int, shape: tuple[int, ...]) -> int:
        t = self._type(vid)
        if t.shape == shape:
            return vid
        k = len(shape) - t.rank
        return self._bcast(vid, shape, tuple(range(k, len(shape))))

    # -- graph walk -------------------------------------------------------

    def walk(self, gm, arg_ids: list[int]) -> list[int]:
        """Lower one graph module; returns the vids of its outputs."""
        env: dict = {}
        self._envs.append(env)
        try:
            return self._walk(gm, arg_ids, env)
        finally:
            self._envs.pop()

    def _walk(self, gm, arg_ids: list[int], env: dict) -> list[int]:
        placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
        if len(placeholders) != len(arg_ids):
            raise UnsupportedOpError(
                f"graph takes {len(placeholders)} inputs, "
                f"{len(arg_ids)} given")
        for node, vid in zip(placeholders, arg_ids):
            env[node] = _Ref(vid)
        for node in gm.graph.nodes:
            if node.op == "placeholder":
                continue
            if node.op == "get_attr":
                env[node] = getattr(gm, node.target)
            elif node.op == "call_function":
                env[node] = self._call(node, env)
            elif node.op == "output":
                outs = pytree.tree_leaves(
                    self._ready(self._args(node.args[0], env)))
                return [o.vid for o in outs]
            else:
                raise UnsupportedOpError(f"node kind {node.op!r}")
        raise UnsupportedOpError("graph has no output node")

    def _args(self, a, env):
        import torch.fx
        if isinstance(a, torch.fx.Node):
            return env[a]
        if isinstance(a, (list, tuple)):
            return type(a)(self._args(x, env) for x in a)
        return a

    def _call(self, node, env):
        target = node.target
        packet = _packet(node)
        args = self._args(node.args, env)
        kwargs = self._args(dict(node.kwargs), env)
        if packet not in _LAZY_ARGS:
            args, kwargs = self._ready(args), self._ready(kwargs)
        if target is operator.getitem:
            return args[0][args[1]]
        if getattr(target, "__name__", "") == "scan" and \
                getattr(target, "namespace", "higher_order") == "higher_order":
            return self._scan(node, *args, **kwargs)
        namespace = getattr(target, "namespace", None)
        if namespace == _KERNEL_NAMESPACE:
            if packet == _GRAD_OP:
                return self._grad(node, args)
            if packet == _TOP_K_OP:
                return self._top_k(node, args)
            return self._kernel(node, packet, args)
        if namespace != "aten" or packet is None:
            raise UnsupportedOpError(f"no IR lowering for {target}")
        if packet in _IGNORED:
            return None
        if packet in _FILLS:
            return _Fill(*_meta(node))
        handler = getattr(self, f"_aten_{packet}", None)
        if handler is not None:
            return handler(node, args, kwargs)
        if packet in _ARITH or packet in _COMPARE:
            return self._elementwise(node, packet, args, kwargs)
        raise UnsupportedOpError(
            f"no IR lowering for aten op {target}; add one to "
            f"repro_torch.core.ir (unknown ops are not elementwise-safe)")

    # -- elementwise --------------------------------------------------------

    def _elementwise(self, node, packet, args, kwargs):
        if kwargs.get("alpha", 1) != 1 or kwargs.get("rounding_mode"):
            raise UnsupportedOpError(f"{node.target} with {kwargs}")
        shape, dtype = _meta(node)
        arith = packet in _ARITH
        prim = _ARITH[packet] if arith else _COMPARE[packet]
        # a comparison's scalar is of its tensor operand's type
        lit_dtype = dtype if arith else next(
            (self._type(a.vid).dtype for a in args if isinstance(a, _Ref)),
            dtype)
        operands = []
        for a in args:
            if isinstance(a, _Ref):
                vid = a.vid
                if arith and self._type(vid).rank > 0:
                    vid = self._convert(vid, dtype)
                operands.append(self._rank_promote(vid, len(shape)))
            elif isinstance(a, (bool, int, float)):
                operands.append(self._literal(lit_dtype))
            else:
                raise UnsupportedOpError(f"{node.target} operand {a!r}")
        return _Ref(self._emit(prim, {}, operands, shape, dtype))

    def _aten_rsub(self, node, args, kwargs):
        return self._elementwise(node, "sub", [args[1], args[0]], kwargs)

    def _aten_pow(self, node, args, kwargs):
        base, exponent = args
        if isinstance(base, (int, float)) and isinstance(exponent, _Ref):
            # a scalar to a tensor power (the optimizer's b ** step)
            shape, dtype = _meta(node)
            vid = self._convert(exponent.vid, dtype)
            return _Ref(self._emit("pow", {}, [self._literal(dtype), vid],
                                   shape, dtype))
        if not isinstance(base, _Ref) or isinstance(exponent, bool) or \
                not isinstance(exponent, int):
            raise UnsupportedOpError(f"{node.target} with a non-integer "
                                     f"or tensor exponent")
        shape, dtype = _meta(node)
        vid = self._convert(base.vid, dtype)
        return _Ref(self._emit("integer_pow", {"y": exponent}, [vid], shape,
                               dtype))

    def _aten_reciprocal(self, node, args, kwargs):
        # a Python scalar over a tensor: 1 / x here, the scalar's mul next
        shape, dtype = _meta(node)
        vid = self._convert(args[0].vid, dtype)
        return _Ref(self._emit("div", {}, [self._literal(dtype), vid],
                               shape, dtype))

    def _aten_relu(self, node, args, kwargs):
        shape, dtype = _meta(node)
        return _Ref(self._emit("max", {}, [args[0].vid, self._literal(dtype)],
                               shape, dtype))

    def _aten_where(self, node, args, kwargs):
        # reference: every case broadcast to the result shape, then
        # select_n(pred, on_false, on_true)
        shape, dtype = _meta(node)
        cond, on_true, on_false = args

        def full(a, dt):
            vid = a.vid if isinstance(a, _Ref) else self._literal(dt)
            if dt != "bool":
                vid = self._convert(vid, dt)
            return self._bcast_to(vid, shape)

        ops = [full(cond, "bool"), full(on_false, dtype),
               full(on_true, dtype)]
        return _Ref(self._emit("select_n", {}, ops, shape, dtype))

    def _convert_node(self, node, args):
        shape, dtype = _meta(node)
        return _Ref(self._convert(args[0].vid, dtype))

    def _aten_to(self, node, args, kwargs):
        return self._convert_node(node, args)

    def _aten__to_copy(self, node, args, kwargs):
        return self._convert_node(node, args)

    def _aten_clone(self, node, args, kwargs):
        # a copy is the value itself in a functional program
        return args[0]

    def _aten_detach(self, node, args, kwargs):
        # the reference's stop_gradient; when the detached value has no
        # other user (and no other node lowered to the same value) the
        # detach is a mark for the differentiator only, so forward
        # programs stay the reference's
        vid = args[0].vid
        src = node.args[0]
        aliases = [n for env in self._envs for n, v in env.items()
                   if isinstance(v, _Ref) and v.vid == vid]
        if len(src.users) == 1 and aliases == [src]:
            self.stopped.add(vid)
            return _Ref(vid)
        shape, dtype = _meta(node)
        out = self._emit("stop_gradient", {}, [vid], shape, dtype)
        self.stopped.add(out)
        return _Ref(out)

    def _aten_clamp(self, node, args, kwargs):
        # jnp.clip: max with the lower bound, then min with the upper
        shape, dtype = _meta(node)
        vid = self._convert(args[0].vid, dtype)
        lo = args[1] if len(args) > 1 else kwargs.get("min")
        hi = args[2] if len(args) > 2 else kwargs.get("max")
        for bound, prim in ((lo, "max"), (hi, "min")):
            if bound is None:
                continue
            if not isinstance(bound, (int, float)):
                raise UnsupportedOpError(f"{node.target} with a tensor "
                                         f"bound")
            vid = self._emit(prim, {}, [vid, self._literal(dtype)], shape,
                             dtype)
        return _Ref(vid)

    def _aten_mean(self, node, args, kwargs):
        # jnp.mean: the sum, divided by the element count
        dims, keep = self._reduce_args(args, kwargs)
        shape, dtype = _meta(node)
        vid = self._convert(args[0].vid, dtype)
        s = self._reduce(node, "reduce_sum", vid, dims, keep)
        return _Ref(self._emit("div", {}, [s, self._literal(dtype)], shape,
                               dtype))

    # -- shape ops ----------------------------------------------------------

    def _reshape(self, node, args):
        shape, dtype = _meta(node)
        vid = args[0].vid
        if self._type(vid).shape == shape:
            return _Ref(vid)
        return _Ref(self._emit("reshape", {"new_sizes": shape,
                                           "dimensions": None},
                               [vid], shape, dtype))

    def _aten_view(self, node, args, kwargs):
        return self._reshape(node, args)

    def _aten_reshape(self, node, args, kwargs):
        return self._reshape(node, args)

    def _aten__unsafe_view(self, node, args, kwargs):
        return self._reshape(node, args)

    def _transpose(self, node, vid, perm):
        shape, dtype = _meta(node)
        if tuple(perm) == tuple(range(len(perm))):
            return _Ref(vid)
        return _Ref(self._emit("transpose", {"permutation": tuple(perm)},
                               [vid], shape, dtype))

    def _aten_permute(self, node, args, kwargs):
        rank = self._type(args[0].vid).rank
        return self._transpose(node, args[0].vid,
                               [_norm_dim(d, rank) for d in args[1]])

    def _aten_t(self, node, args, kwargs):
        rank = self._type(args[0].vid).rank
        return self._transpose(node, args[0].vid, list(range(rank))[::-1])

    def _aten_numpy_T(self, node, args, kwargs):
        return self._aten_t(node, args, kwargs)

    def _aten_unsqueeze(self, node, args, kwargs):
        shape, _ = _meta(node)
        d = _norm_dim(args[1], len(shape))
        src = args[0]
        if isinstance(src, _Unsqueezed):
            vid, bdims = src.vid, tuple(b + (b >= d) for b in src.bdims)
        else:
            vid = self._ready(src).vid
            bdims = tuple(i for i in range(len(shape)) if i != d)
        users = list(node.users)
        if len(users) == 1 and _packet(users[0]) == "unsqueeze":
            return _Unsqueezed(vid, bdims)
        if self._type(vid).rank == 0 and users and all(
                _packet(u) == "index_copy" and u.args[2] is node and
                node not in (u.args[0], u.args[3]) for u in users):
            return _SlotIndex(vid)
        return _Ref(self._bcast(vid, shape, bdims))

    def _aten_index_copy(self, node, args, kwargs):
        # reference: lax.dynamic_update_slice(operand, update, starts),
        # the written dim's start the scalar, literal zeros elsewhere
        operand, dim, index, source = args
        if not isinstance(index, _SlotIndex):
            raise UnsupportedOpError(
                f"{node.target} with an index that is not one scalar "
                f"slot (slot[None])")
        operand, source = self._ready(operand), self._ready(source)
        shape, dtype = _meta(node)
        dim = _norm_dim(dim, len(shape))
        if self._type(source.vid).shape[dim] != 1:
            raise UnsupportedOpError(f"{node.target} of more than one slot")
        starts = [index.vid if i == dim else self._literal("int32")
                  for i in range(len(shape))]
        return _Ref(self._emit("dynamic_update_slice", {},
                               [operand.vid, source.vid, *starts], shape,
                               dtype))

    def _aten_expand(self, node, args, kwargs):
        shape, _ = _meta(node)
        users = list(node.users)
        if users and all(
                (_packet(u), i) in _EXPAND_USERS
                for u in users for i, a in enumerate(u.args) if a is node):
            return _Expanded(args[0].vid, shape)
        return _Ref(self._bcast_to(args[0].vid, shape))

    def _slice(self, vid, dim, start, end, step):
        t = self._type(vid)
        starts = [0] * t.rank
        limits = list(t.shape)
        starts[dim], limits[dim] = start, end
        out = list(t.shape)
        out[dim] = len(range(start, end, step))
        return self._emit("slice", {"start_indices": tuple(starts),
                                    "limit_indices": tuple(limits),
                                    "strides": None if step == 1 else
                                    tuple(step if i == dim else 1
                                          for i in range(t.rank))},
                          [vid], out, t.dtype)

    def _aten_slice(self, node, args, kwargs):
        vid = args[0].vid
        t = self._type(vid)
        dim = _norm_dim(args[1] if len(args) > 1 else 0, t.rank)
        start, end, step = slice(
            *(list(args[2:5]) + [None] * (5 - len(args)))[:3]
        ).indices(t.shape[dim])
        if (start, end, step) == (0, t.shape[dim], 1):
            return _Ref(vid)
        return _Ref(self._slice(vid, dim, start, end, step))

    def _aten_select(self, node, args, kwargs):
        vid = args[0].vid
        t = self._type(vid)
        dim = _norm_dim(args[1], t.rank)
        idx = _norm_dim(args[2], t.shape[dim])
        sl = self._slice(vid, dim, idx, idx + 1, 1)
        shape, dtype = _meta(node)
        return _Ref(self._emit("squeeze", {"dimensions": (dim,)}, [sl],
                               shape, dtype))

    def _aten_squeeze(self, node, args, kwargs):
        vid = args[0].vid
        t = self._type(vid)
        dims = args[1] if len(args) > 1 else [
            i for i, n in enumerate(t.shape) if n == 1]
        dims = [dims] if isinstance(dims, int) else dims
        dims = tuple(sorted(_norm_dim(d, t.rank) for d in dims
                            if t.shape[_norm_dim(d, t.rank)] == 1))
        if not dims:
            return _Ref(vid)
        shape, dtype = _meta(node)
        return _Ref(self._emit("squeeze", {"dimensions": dims}, [vid], shape,
                               dtype))

    def _aten_cat(self, node, args, kwargs):
        shape, dtype = _meta(node)
        tensors = [a.vid for a in args[0]]
        dim = _norm_dim(args[1] if len(args) > 1 else kwargs.get("dim", 0),
                        len(shape))
        return _Ref(self._emit("concatenate", {"dimension": dim},
                               [self._convert(v, dtype) for v in tensors],
                               shape, dtype))

    def _aten_slice_scatter(self, node, args, kwargs):
        # reference: lax.pad(src, 0, (lo, hi, interior)) along ``dim``
        base, src = args[0], self._ready(args[1])
        rest = list(args[2:]) + [None] * (5 - len(args))
        dim = rest[0] if rest[0] is not None else kwargs.get("dim", 0)
        start = rest[1] if rest[1] is not None else kwargs.get("start")
        end = rest[2] if rest[2] is not None else kwargs.get("end")
        step = rest[3] if rest[3] is not None else kwargs.get("step", 1)
        if not isinstance(base, _Fill) or not isinstance(src, _Ref):
            raise UnsupportedOpError(
                f"{node.target} into a base that is not a constant fill")
        shape, dtype = _meta(node)
        dim = _norm_dim(dim, len(shape))
        lo, stop, step = slice(start, end, step).indices(shape[dim])
        n = len(range(lo, stop, step))
        if n == 0 or self._type(src.vid).shape[dim] != n:
            raise UnsupportedOpError(f"{node.target} of an empty or "
                                     f"misshapen source")
        hi = shape[dim] - (lo + (n - 1) * step + 1)
        config = tuple((lo, hi, step - 1) if i == dim else (0, 0, 0)
                       for i in range(len(shape)))
        return _Ref(self._emit(
            "pad", {"padding_config": config},
            [self._convert(src.vid, dtype), self._literal(dtype)], shape,
            dtype))

    def _aten_split(self, node, args, kwargs):
        # reference: jnp.split's one multi-result ``split`` prim
        vid = args[0].vid
        t = self._type(vid)
        size = args[1] if len(args) > 1 else kwargs["split_size"]
        dim = _norm_dim(args[2] if len(args) > 2 else kwargs.get("dim", 0),
                        t.rank)
        if isinstance(size, int):
            # chunks of ``size``, the last one what is left
            n = t.shape[dim]
            sizes = [size] * (n // size) + ([n % size] if n % size else [])
        else:
            sizes = list(size)
        return self._split(node, vid, sizes, dim)

    def _aten_split_with_sizes(self, node, args, kwargs):
        vid = args[0].vid
        dim = args[2] if len(args) > 2 else kwargs.get("dim", 0)
        return self._split(node, vid, list(args[1]),
                           _norm_dim(dim, self._type(vid).rank))

    def _split(self, node, vid, sizes, dim):
        vals = node.meta["val"]
        if sum(sizes) != self._type(vid).shape[dim] or \
                len(vals) != len(sizes):
            raise UnsupportedOpError(f"{node.target} into {sizes}")
        vids = [self.prog.new_value(tuple(int(d) for d in v.shape),
                                    dtype_name(v.dtype)) for v in vals]
        self.prog.add_op(Op("split", {"sizes": tuple(int(n) for n in sizes),
                                      "axis": dim}, [vid], vids), self.trip)
        return tuple(_Ref(v) for v in vids)

    def _aten_tril(self, node, args, kwargs):
        # reference lowering of jnp.tril(x, k) on a matrix: the mask
        # row + k >= col of two iotas, then select_n(mask, zeros, x)
        x = args[0].vid
        k = args[1] if len(args) > 1 else kwargs.get("diagonal", 0)
        shape, dtype = _meta(node)
        if len(shape) != 2 or not isinstance(k, int):
            raise UnsupportedOpError(f"{node.target} of rank {len(shape)}")

        def iota(d):
            return self._emit("iota", {"dtype": "int32", "shape": shape,
                                       "dimension": d}, [], shape, "int32")

        rows = self._emit("add", {}, [iota(0), self._literal("int32")],
                          shape, "int32")
        cols = iota(1)
        mask = self._emit("ge", {}, [rows, cols], shape, "bool")
        zeros = self._bcast(self._literal(dtype), shape, ())
        return _Ref(self._emit("select_n", {}, [mask, zeros, x], shape,
                               dtype))

    # -- reductions ---------------------------------------------------------

    def _reduce(self, node, prim, vid, dims, keepdim):
        shape, dtype = _meta(node)
        t = self._type(vid)
        axes = tuple(sorted({_norm_dim(d, t.rank) for d in dims})) \
            if dims else tuple(range(t.rank))
        kept = tuple(i for i in range(t.rank) if i not in axes)
        red_shape = tuple(t.shape[i] for i in kept)
        out = self._emit(prim, {"axes": axes}, [vid], red_shape, dtype)
        if keepdim:
            out = self._bcast(out, shape, kept)
        return out

    @staticmethod
    def _reduce_args(args, kwargs):
        dims = args[1] if len(args) > 1 else kwargs.get("dim")
        dims = [dims] if isinstance(dims, int) else (dims or [])
        keep = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
        return dims, keep

    def _aten_sum(self, node, args, kwargs):
        dims, keep = self._reduce_args(args, kwargs)
        vid = self._convert(args[0].vid, _meta(node)[1])
        return _Ref(self._reduce(node, "reduce_sum", vid, dims, keep))

    def _aten_cumsum(self, node, args, kwargs):
        # reference: the ``cumsum`` prim along one axis, forwards
        shape, dtype = _meta(node)
        dim = args[1] if len(args) > 1 else kwargs["dim"]
        vid = self._convert(args[0].vid, dtype)
        return _Ref(self._emit("cumsum", {"axis": _norm_dim(dim, len(shape)),
                                          "reverse": False}, [vid], shape,
                               dtype))

    def _aten_amax(self, node, args, kwargs):
        dims, keep = self._reduce_args(args, kwargs)
        return _Ref(self._reduce(node, "reduce_max", args[0].vid, dims,
                                 keep))

    # -- contractions -------------------------------------------------------

    def _dot(self, node, lhs, rhs, lc, rc, lb, rb):
        shape, dtype = _meta(node)
        return self._emit(
            "dot_general",
            {"dimension_numbers": ((tuple(lc), tuple(rc)),
                                   (tuple(lb), tuple(rb))),
             "precision": None, "preferred_element_type": dtype},
            [lhs, rhs], shape, dtype)

    def _aten_matmul(self, node, args, kwargs):
        a, b = args[0].vid, args[1].vid
        na, nb = self._type(a).rank, self._type(b).rank
        if nb == 2 and na >= 1:
            return _Ref(self._dot(node, a, b, (na - 1,), (0,), (), ()))
        if na == nb and na >= 3 and \
                self._type(a).shape[:-2] == self._type(b).shape[:-2]:
            batch = tuple(range(na - 2))
            return _Ref(self._dot(node, a, b, (na - 1,), (na - 2,),
                                  batch, batch))
        raise UnsupportedOpError(
            f"matmul of ranks {na} x {nb} (broadcast batch dims)")

    def _aten_einsum(self, node, args, kwargs):
        eq = args[0].replace(" ", "")
        operands = [a.vid for a in args[1]]
        if "..." in eq or "->" not in eq or len(operands) != 2:
            raise UnsupportedOpError(f"einsum {eq!r} with {len(operands)} "
                                     f"operands")
        ins, out = eq.split("->")
        first, second = ins.split(",")
        if len(set(first)) != len(first) or len(set(second)) != len(second) \
                or any(c not in first and c not in second for c in out) or \
                any(c not in out for c in set(first) ^ set(second)):
            raise UnsupportedOpError(f"einsum {eq!r}")
        # jnp.einsum's pairwise contraction: the second operand is the
        # lhs, contracted names sorted, batch names in the result's order,
        # and the operands swapped when that makes the product's dims the
        # result's own
        batch = [c for c in out if c in first and c in second]
        contract = sorted(c for c in first if c in second and c not in out)
        (ls, lhs), (rs, rhs) = (second, operands[1]), (first, operands[0])
        if batch + [c for c in rs if c not in ls] + \
                [c for c in ls if c not in rs] == list(out):
            (ls, lhs), (rs, rhs) = (rs, rhs), (ls, lhs)
        dg_letters = batch + [c for c in ls if c not in rs] + \
            [c for c in rs if c not in ls]
        operands = [lhs, rhs]
        shape, dtype = _meta(node)
        dg_shape = [shape[out.index(c)] for c in dg_letters]
        vid = self.prog.new_value(dg_shape, dtype)
        self.prog.add_op(Op(
            "dot_general",
            {"dimension_numbers": (
                (tuple(ls.index(c) for c in contract),
                 tuple(rs.index(c) for c in contract)),
                (tuple(ls.index(c) for c in batch),
                 tuple(rs.index(c) for c in batch))),
             "precision": None, "preferred_element_type": dtype},
            operands, [vid]), self.trip)
        perm = [dg_letters.index(c) for c in out]
        return self._transpose(node, vid, perm)

    # -- sources --------------------------------------------------------------

    def _aten_arange(self, node, args, kwargs):
        shape, dtype = _meta(node)
        start, step = 0, 1
        if len(args) >= 2:
            start = args[0]
        if len(args) >= 3:
            step = args[2]
        vid = self._emit("iota", {"dtype": dtype, "shape": shape,
                                  "dimension": 0}, [], shape, dtype)
        if step != 1:
            vid = self._emit("mul", {}, [vid, self._literal(dtype)], shape,
                             dtype)
        if start != 0:
            vid = self._emit("add", {}, [vid, self._literal(dtype)], shape,
                             dtype)
        return _Ref(vid)

    def _aten_embedding(self, node, args, kwargs):
        # reference lowering of jnp.take(table, idx, axis=0): index
        # vector dim appended, then a gather of full table rows
        shape, dtype = _meta(node)
        table, idx = args[0].vid, args[1].vid
        it = self._type(idx)
        idx1 = self._bcast(idx, it.shape + (1,), tuple(range(it.rank)))
        dn = GatherDimensionNumbers(offset_dims=(it.rank,),
                                    collapsed_slice_dims=(0,),
                                    start_index_map=(0,))
        return _Ref(self._emit(
            "gather", {"dimension_numbers": dn,
                       "slice_sizes": (1, self._type(table).shape[1])},
            [table, idx1], shape, dtype))

    def _broadcast_base(self, node, x, dim: int, shape) -> tuple[int, tuple]:
        """A gather / scatter argument as its unexpanded value and shape.

        The argument as the op sees it (expanded or not) must be
        ``shape`` on every dim but ``dim``, and its unexpanded value
        broadcast to it: torch would otherwise read a prefix of a dim,
        which no ``jnp`` indexing does.
        """
        vid = x.vid
        base = self._type(vid).shape
        full = x.shape if isinstance(x, _Expanded) else base
        if len(base) != len(shape) or len(full) != len(shape):
            raise UnsupportedOpError(f"{node.target} of mixed ranks")
        for i, (b, f, n) in enumerate(zip(base, full, shape)):
            if i != dim and (f != n or b not in (1, n)):
                raise UnsupportedOpError(
                    f"{node.target}: dim {i} of size {b} (expanded {f}) "
                    f"does not broadcast to {n}")
        return vid, base

    def _aten_gather(self, node, args, kwargs):
        # reference lowering of jnp.take_along_axis(arr, idx, dim) on the
        # unexpanded operands: per dim but ``dim``, an index of size 1
        # takes the operand's dim whole (an offset dim), an operand of
        # size 1 is squeezed (the dim comes from the index), else both
        # are batching dims; the index gets its vector dim appended
        src, dim, idx = args[0], args[1], args[2]
        shape, dtype = _meta(node)
        rank = len(shape)
        dim = _norm_dim(dim, rank)
        src, arr_shape = self._broadcast_base(node, src, dim, shape)
        idx, idx_shape = self._broadcast_base(node, idx, dim, shape)
        offset, collapsed, start_map, obatch, ibatch = [], [], [], [], []
        slice_sizes, squeeze = [], []
        new_i = j = 0
        for i in range(rank):
            if i == dim:
                slice_sizes.append(1)
                start_map.append(new_i)
                collapsed.append(new_i)
                new_i += 1
                j += 1
            elif idx_shape[i] == 1:
                offset.append(i)
                slice_sizes.append(arr_shape[i])
                new_i += 1
            elif arr_shape[i] == 1:
                squeeze.append(i)
                j += 1
            else:
                slice_sizes.append(1)
                obatch.append(new_i)
                ibatch.append(j)
                new_i += 1
                j += 1
        kept = [i for i in range(rank) if i == dim or idx_shape[i] != 1]
        ishape = tuple(shape[i] for i in kept) + (1,)
        if ishape != idx_shape:
            it = self._type(idx)
            idx = self._emit("reshape", {"new_sizes": ishape,
                                         "dimensions": None},
                             [idx], ishape, it.dtype)
        if squeeze:
            st = self._type(src)
            src = self._emit("squeeze", {"dimensions": tuple(squeeze)},
                             [src], tuple(n for i, n in enumerate(st.shape)
                                          if i not in squeeze), st.dtype)
        dn = GatherDimensionNumbers(
            offset_dims=tuple(offset), collapsed_slice_dims=tuple(collapsed),
            start_index_map=tuple(start_map),
            operand_batching_dims=tuple(obatch),
            start_indices_batching_dims=tuple(ibatch))
        return _Ref(self._emit(
            "gather", {"dimension_numbers": dn,
                       "slice_sizes": tuple(slice_sizes)},
            [src, idx], shape, dtype))

    def _aten_scatter_add(self, node, args, kwargs):
        # reference lowering of ``base.at[idx].add(upd)`` along ``dim``
        # under vmap over the dims before it: those are batching dims
        # whatever their size (a batch of one included), the dims after
        # ``dim`` window dims of the update (the operand's dims whole);
        # the index drops its window dims and gets its vector dim
        # appended
        base, dim, idx, upd = args
        shape, dtype = _meta(node)
        rank = len(shape)
        dim = _norm_dim(dim, rank)
        ut = self._type(upd.vid)
        if ut.rank != rank or any(ut.shape[i] != shape[i]
                                  for i in range(rank) if i != dim):
            raise UnsupportedOpError(f"{node.target} of an update that "
                                     f"does not span the operand")
        full = idx.shape if isinstance(idx, _Expanded) else \
            self._type(idx.vid).shape
        if tuple(full) != ut.shape:
            raise UnsupportedOpError(f"{node.target} of an update shaped "
                                     f"unlike its index")
        idx, idx_shape = self._broadcast_base(node, idx, dim, ut.shape)
        if any(idx_shape[i] != ut.shape[i] for i in range(dim)) or any(
                idx_shape[i] != 1 for i in range(dim + 1, rank)):
            raise UnsupportedOpError(f"{node.target} of an index that is "
                                     f"not one row of indices per vmap "
                                     f"batch")
        window = list(range(dim + 1, rank))
        scatter = [i for i in range(rank) if i not in window]
        batch = [i for i in scatter if i != dim]
        ishape = tuple(idx_shape[i] for i in scatter) + (1,)
        if ishape != idx_shape:
            idx = self._emit("reshape", {"new_sizes": ishape,
                                         "dimensions": None},
                             [idx], ishape, self._type(idx).dtype)
        dn = ScatterDimensionNumbers(
            update_window_dims=tuple(window), inserted_window_dims=(dim,),
            scatter_dims_to_operand_dims=(dim,),
            operand_batching_dims=tuple(batch),
            scatter_indices_batching_dims=tuple(scatter.index(i)
                                                for i in batch))
        return _Ref(self._emit(
            "scatter-add", {"dimension_numbers": dn,
                            "indices_are_sorted": False,
                            "unique_indices": False},
            [self._convert(base.vid, dtype), idx, upd.vid], shape, dtype))

    # -- fused kernels and loops ---------------------------------------------

    def _kernel(self, node, name, args):
        spec = kernel_registry.KERNELS.get(name)
        n = 0 if spec is None else len(spec.operand_roles)
        if spec is None or len(args) < n or any(
                not isinstance(a, _Ref) or self._type(a.vid).rank != len(r)
                for a, r in zip(args[:n], spec.operand_roles)):
            raise UnsupportedOpError(
                f"custom op {node.target} does not match a registry "
                f"kernel contract")
        params: dict = {"kernel": spec.name}
        if spec.name.startswith("flash_attention"):
            params["causal"] = bool(args[n])
        if len(spec.result_roles) == 1:
            shape, dtype = _meta(node)
            return _Ref(self._emit(spec.prim, params,
                                   [a.vid for a in args[:n]], shape, dtype))
        # a backward: one result per differentiated operand
        vids = [self.prog.new_value(tuple(int(d) for d in v.shape),
                                    dtype_name(v.dtype))
                for v in node.meta["val"]]
        self.prog.add_op(Op(spec.prim, params, [a.vid for a in args[:n]],
                            vids), self.trip)
        return tuple(_Ref(v) for v in vids)

    def _top_k(self, node, args):
        # lax.top_k along the last dim: values and indices
        x, k = args
        rank = self._type(x.vid).rank
        vids = [self.prog.new_value(tuple(int(d) for d in v.shape),
                                    dtype_name(v.dtype))
                for v in node.meta["val"]]
        self.prog.add_op(Op("top_k", {"k": int(k), "axis": rank - 1},
                            [x.vid], vids), self.trip)
        return tuple(_Ref(v) for v in vids)

    def _grad(self, node, args):
        from repro_torch.core import autodiff
        loss, wrt, remat = args
        if self.trip != 1 or self._open:
            raise UnsupportedOpError("a gradient node inside a scan body")
        grads = autodiff.value_and_grad(
            self.prog, self.scans, loss.vid, [w.vid for w in wrt],
            self.stopped, bool(remat))
        self.scans = []
        return [_Ref(g) for g in grads]

    def _scan(self, node, body_gm, init, xs, additional=(), **kwargs):
        if kwargs:
            raise UnsupportedOpError(f"scan with {sorted(kwargs)}")
        carries = [a.vid for a in init]
        xss = [a.vid for a in xs]
        consts = [a.vid for a in additional]
        if not xss:
            raise UnsupportedOpError("scan without xs")
        length = self._type(xss[0]).shape[0]
        # one symbolic iteration: body carries fresh values dim-linked to
        # the outer carries; body xs = one slice of xss; consts as-is
        body_carry_ids = []
        for c in carries:
            t = self._type(c)
            b = self.prog.new_value(t.shape, t.dtype)
            self.prog.value_links.append((c, b, 0))
            body_carry_ids.append(b)
        body_xs_ids = []
        for x in xss:
            t = self._type(x)
            b = self.prog.new_value(t.shape[1:], t.dtype)
            self.prog.value_links.append((x, b, 1))
            body_xs_ids.append(b)
        outer_trip = self.trip
        self.trip = outer_trip * length
        lo = len(self.prog.ops)
        # the scans of this body, recorded as they close
        self._open.append([])
        outs = self.walk(body_gm, body_carry_ids + body_xs_ids + consts)
        children = self._open.pop()
        hi = len(self.prog.ops)
        self.trip = outer_trip
        carry_outs, y_outs = outs[:len(carries)], outs[len(carries):]
        results = []
        vals = node.meta["val"]
        for i, val in enumerate(vals):
            vid = self.prog.new_value(tuple(int(s) for s in val.shape),
                                      val.dtype)
            results.append(_Ref(vid))
            if i < len(carries):
                # loop: body carry out ≗ outer result ≗ body carry in
                self.prog.value_links.append((carry_outs[i], vid, 0))
                self.prog.value_links.append((body_carry_ids[i], vid, 0))
            else:
                self.prog.value_links.append(
                    (vid, y_outs[i - len(carries)], 1))
        from repro_torch.core.autodiff import ScanRecord
        rec = ScanRecord(
            lo, hi, length, carries, xss, consts, body_carry_ids,
            body_xs_ids, carry_outs, y_outs, [r.vid for r in results],
            trip=outer_trip, children=children)
        for c in children:
            c.parent = rec
        # a top-level scan in ``scans``, a nested one in its parent's
        # ``children``
        (self._open[-1] if self._open else self.scans).append(rec)
        return tuple(results)


# memory addresses in default object reprs ("<function f at 0x7f..>")
_ADDR_RE = re.compile(r"0x[0-9a-fA-F]{4,}")


def _canon(x) -> str:
    """Deterministic canonical string for an op param value.

    Used by :func:`program_fingerprint`, so the result must be identical
    across processes and interpreter runs: no ``id()``, no default object
    ``repr`` (which embeds addresses), no ``hash()`` (salted by
    PYTHONHASHSEED).  Unknown objects degrade to their type name.
    """
    if x is None or isinstance(x, (bool, int, float, str)):
        return repr(x)
    if isinstance(x, bytes):
        return f"bytes:{hashlib.sha256(x).hexdigest()}"
    if isinstance(x, np.dtype):
        return f"dtype:{x.name}"
    if isinstance(x, np.ndarray):
        return (f"ndarray:{x.shape}:{x.dtype.name}:"
                f"{hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()}")
    if isinstance(x, (tuple, list)):
        return "[" + ",".join(_canon(e) for e in x) + "]"
    if isinstance(x, (set, frozenset)):
        return "{" + ",".join(sorted(_canon(e) for e in x)) + "}"
    if isinstance(x, dict):
        items = sorted((_canon(k), _canon(v)) for k, v in x.items())
        return "{" + ",".join(f"{k}:{v}" for k, v in items) + "}"
    try:
        if isinstance(x, np.generic):
            return f"npscalar:{x.dtype.name}:{x!r}"
        s = str(x)
    except Exception:                                      # noqa: BLE001
        s = ""
    if not s or _ADDR_RE.search(s):
        return f"<{type(x).__module__}.{type(x).__qualname__}>"
    return f"{type(x).__qualname__}:{s}"


def program_fingerprint(prog: Program) -> str:
    """Deterministic content hash of a :class:`Program`.

    The fingerprint covers everything the downstream analysis can observe:
    op primitives and canonicalized params, the operand/result value-id
    wiring, tensor types, input/output ids, scan value links, and trip
    counts.  It is a pure function of the traced computation — stable
    across processes, PYTHONHASHSEED values, and re-traces of the same
    function.

    Args:
        prog: the extracted program to hash.

    Returns:
        A 64-char hex SHA-256 digest.
    """
    h = hashlib.sha256()

    def feed(s: str) -> None:
        h.update(s.encode())
        h.update(b"\x00")

    for i, op in enumerate(prog.ops):
        feed(f"op{i}:{op.prim}")
        feed(_canon(op.params))
        feed(_canon(op.operands))
        feed(_canon(op.results))
        feed(_canon(op.meta))
        feed(f"trip:{prog.trip_counts.get(i, 1)}")
    for vid in sorted(prog.types):
        t = prog.types[vid]
        feed(f"v{vid}:{t.shape}:{t.dtype}")
    feed(_canon(prog.inputs))
    feed(_canon(prog.outputs))
    feed(_canon(sorted(prog.value_links)))
    return h.hexdigest()


def export_graph(fn, args: tuple, kwargs: dict | None = None):
    """``torch.export`` ``fn`` on ``meta`` stand-ins of its tensor leaves.

    Args:
        fn: the function to trace (never executed on data).
        args: example positional arguments; tensors of any device, or
            ``meta`` tensors.
        kwargs: example keyword arguments.

    Returns:
        ``(exported program, leaves, input key paths)``; the exported
        function takes the flat leaves in the reference's pytree order.
    """
    import torch

    tree = (tuple(args), dict(kwargs or {}))
    leaves, paths = pytree.flatten_with_paths(tree)
    for path, leaf in zip(paths, leaves):
        if not isinstance(leaf, torch.Tensor):
            raise TypeError(f"input {path} is a {type(leaf).__name__}; "
                            f"every input leaf must be a tensor")
    metas = tuple(torch.empty(x.shape, dtype=x.dtype, device="meta")
                  for x in leaves)

    class _Flat(torch.nn.Module):
        def forward(self, *flat):
            a, kw = pytree.unflatten(tree, flat)
            # outputs in the reference's order too (dicts by sorted key)
            return pytree.tree_leaves(fn(*a, **kw))

    ep = torch.export.export(_Flat(), metas, strict=False)
    return ep, leaves, paths


def extract_program(fn, *args, **kwargs) -> Program:
    """Export ``fn`` on ``meta`` tensors and extract the flat Program.

    Args:
        fn: the function to trace (never executed on data).
        *args: example positional arguments (``meta`` tensors suffice).
        **kwargs: example keyword arguments.

    Returns:
        The :class:`Program`, with ``input_paths`` in the reference's
        key-path spelling.

    Raises:
        UnsupportedOpError: on an exported node the tracer cannot lower.
    """
    ep, leaves, paths = export_graph(fn, args, kwargs)
    sig = ep.graph_signature
    if len(sig.user_inputs) != len(sig.input_specs):
        raise UnsupportedOpError(
            "the traced function holds parameters, buffers or tensor "
            "constants of its own; pass every tensor as an argument")
    ex = _Extractor()
    arg_ids = [ex.prog.new_value(x.shape, x.dtype) for x in leaves]
    ex.prog.inputs = list(arg_ids)
    ex.prog.input_paths = list(paths)
    ex.prog.outputs = ex.walk(ep.graph_module, arg_ids)
    return ex.prog
