"""Reverse-mode differentiation of a traced :class:`~repro_torch.core.ir.Program`.

The train step's program is the reference's ``jax.value_and_grad`` of
the loss followed by the AdamW update.  ``torch.export`` cannot give that
program's backward with the layer scan kept whole, so the tracer
(``core.ir``) exports the loss's forward only, and on the train step's
``repro_torch::grad`` node calls :func:`value_and_grad` here, which
builds the backward in the IR itself by the reference's rules — JAX's
linearize-then-transpose, prim by prim:

- each differentiated op's JVP splits into *residual* ops, on primal
  values only (``rsqrt``'s ``-0.5 * ans / x``, ``logistic``'s ``ans * (1
  - ans)``, ``div``'s ``y**-2``, ``reduce_max``'s location counts,
  ``max``'s tie weights, ``top_k``'s indices with a unit index dim, the
  zeros ``scatter-add`` instantiates for an operand without a tangent,
  ...), and *linear* ops on tangents, recorded on a tape (``top_k``'s
  values: a ``gather`` of the tangent at the indices); the residuals
  follow their op, in the JVP's order;
- a few ops form one unit with a JVP of its own, as JAX's
  ``custom_jvp``: ``jnp.logaddexp``'s steps (softplus) take its rule,
  ``t * exp(x - out)`` with its ``inf`` guards, and their inner ops none;
- the tape is transposed in reverse: ``dot_general`` into a
  ``dot_general`` and a ``transpose``, ``broadcast_in_dim`` into
  ``reduce_sum``, ``slice`` into ``pad``, ``pad`` into a negative
  ``pad`` and a strided ``slice``, ``concatenate`` into ``split``,
  ``gather`` into ``scatter-add`` into zeros, ``scatter-add`` into its
  cotangent for the operand and a ``gather`` of it for the updates,
  ``select_n`` into a
  ``select_n`` against zeros, ``split`` into ``concatenate`` (zeros for
  the pieces without a cotangent), ``cumsum`` into a ``cumsum`` the
  other way, a fused kernel into its backward op
  (``kernel:flash_attention_bwd``, ``kernel:rg_lru_bwd``); fanned-out
  cotangents meet in ``add_any``;
- each scan becomes a forward scan and a backward scan, each one body
  with trip counts and value links; a scan may follow another (the
  encoder's, whose result the decoder's body reads) or run inside one's
  body (the sLSTM's time scan), whose forward and backward then run
  inside the enclosing forward and backward bodies.  The forward body's
  loop-invariant ops and residuals (rope tables, masks, constants) are
  hoisted out of it, as the reference's scan partial evaluation does
  (a nested scan's into the enclosing body, and further if they do not
  vary there either), and its dead ops dropped with their values.
  Without remat the forward body also computes the residuals the
  backward body reads and stacks them as ``ys`` (a nested scan's stacks
  stacked again); with remat it stacks only the carry, and the backward
  body recomputes the forward body's ops the transpose needs (invariant
  ones included, a nested scan with its residuals), as under
  ``jax.checkpoint``.  The backward scan carries the cotangents of the
  forward's carries and, as JAX's scan transpose, one accumulator per
  differentiated constant the body reads (zeros in, the contributions
  added in the body, the sum out); the stacked ``ys``' cotangents are
  its ``xs``; the zero tangents JAX instantiates for a carry whose init
  has none are emitted where the reference's program holds them.  Ops
  after the scan (a tail of unscanned layers) are differentiated at the
  top level and not recomputed;
- residual and linear ops that reach no gradient are dropped inside scan
  bodies and kept at the top level, as the reference's program keeps
  them (its top level is not dead-code eliminated).

An op this module has no rule for raises :class:`NotImplementedError`
when a gradient would flow through it.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.core.ir import (GatherDimensionNumbers,
                                 ScatterDimensionNumbers)

# prims whose results carry no tangent (integer / boolean results, or
# the gradient explicitly stopped)
_NO_TANGENT = frozenset({
    "iota", "eq", "ne", "lt", "le", "gt", "ge", "and", "or", "not",
    "is_finite", "stop_gradient", "sign", "rem",
})
_FLOAT = frozenset({"float16", "bfloat16", "float32", "float64"})


@dataclasses.dataclass
class ScanRecord:
    """One scan as the tracer instantiated it: its body's ops are
    ``prog.ops[lo:hi]`` (its nested scans' among them), run ``length``
    times each time the scan runs; the scan runs ``trip`` times (the
    product of the lengths of the scans around it)."""

    lo: int
    hi: int
    length: int
    carries: list[int]           # outer init values
    xs: list[int]                # outer stacked inputs
    consts: list[int]            # outer values the body reads
    body_carry: list[int]        # body carry-in values
    body_xs: list[int]           # body slices of xs
    carry_outs: list[int]        # body carry-out values
    y_outs: list[int]            # body ys
    results: list[int]           # outer carries out, then stacked ys
    trip: int = 1
    # the scan whose body holds this one, and the scans this one's body
    # holds, in order
    parent: ScanRecord | None = dataclasses.field(
        default=None, repr=False, compare=False)
    children: list[ScanRecord] = dataclasses.field(
        default_factory=list, repr=False, compare=False)


@dataclasses.dataclass(eq=False)
class R:
    """A residual op on primal values, emitted when first needed."""

    prim: str
    params: dict
    operands: list               # vids, R's or Lit's
    shape: tuple[int, ...]
    dtype: str


@dataclasses.dataclass(frozen=True)
class Lit:
    """A fresh scalar literal of ``dtype`` at each use."""

    dtype: str


@dataclasses.dataclass(eq=False)
class Lin:
    """One linear op of the tape.

    ``args`` holds tangent keys as ``("t", key)`` and primal operands as
    vids, :class:`R` or :class:`Lit`; ``out`` is the result's tangent key.
    """

    prim: str
    params: dict
    args: list
    out: Any = None
    scan: Any = None             # a "scan" entry's _Plan (None: dead)


def _t(key) -> tuple:
    return ("t", key)


def _is_t(a) -> bool:
    return isinstance(a, tuple) and len(a) == 2 and a[0] == "t"


class _Ctx:
    """Where ops are emitted: a trip count and a renaming of primal
    values (a scan body's forward values -> its backward body's), inside
    the context of the enclosing body (``parent``), whose names and
    residuals it sees.  In a ``fresh`` context the forward ops emitted
    again (a recomputation) get values of their own."""

    def __init__(self, trip: int, parent: _Ctx | None = None,
                 fresh: bool = False) -> None:
        self.trip = trip
        self.parent = parent
        self.fresh = fresh
        self.rename: dict = {}
        self.memo: dict = {}       # R -> vid
        # value -> the maker of its renaming, called at its first use
        self.lazy: dict = {}

    def name(self, v: int) -> int:
        """``v`` as this context holds it."""
        ctx = self
        while ctx is not None:
            if v in ctx.rename:
                return ctx.rename[v]
            if v in ctx.lazy:
                ctx.rename[v] = ctx.lazy.pop(v)()
                return ctx.rename[v]
            ctx = ctx.parent
        return v

    def find(self, r: R) -> int | None:
        """The value of residual ``r`` here, if it was emitted."""
        ctx = self
        while ctx is not None:
            if r in ctx.memo:
                return ctx.memo[r]
            ctx = ctx.parent
        return None


@dataclasses.dataclass(eq=False)
class _Plan:
    """One scan's linearization: its body in the order of its JVP, the
    live part of its tape and the residuals its backward reads."""

    rec: ScanRecord
    remat: bool
    units: list                  # body ops and nested scans' plans
    seq: list                    # units and residual R's, in JVP order
    tape: list                   # the live linear entries of the body
    needed: list                 # primal values the live entries need
    direct: list                 # what the live entries read themselves
    seen: set                    # keys of ``needed``
    hoisted: set                 # ids of loop-invariant ops
    variant: set                 # body values that vary by iteration
    keep_fwd: set                # ids of the units the forward keeps
    keep_res: set                # ... those kept with the residuals
    stack_keys: list             # per-iteration residuals stacked as ys
    stacks: list                 # one R standing for each stack
    consts: list                 # the differentiated consts
    lin: Lin | None = None       # its entry on the enclosing tape
    # a nested scan's loop-invariant ops, which its enclosing body runs
    lifted: list = dataclasses.field(default_factory=list)

    def r_variant(self, x) -> bool:
        if isinstance(x, R):
            return any(self.r_variant(o) for o in x.operands)
        return isinstance(x, int) and x in self.variant


def _key(x):
    return ("r", id(x)) if isinstance(x, R) else x


def _outs(e: Lin) -> tuple:
    return e.out if isinstance(e.out, tuple) else (e.out,)


def _operands(u) -> list:
    if isinstance(u, _Plan):
        return u.rec.carries + u.rec.xs + u.rec.consts + \
            [r for op in u.lifted for r in op.results]
    return u.operands


def _results(u) -> list:
    return u.rec.results if isinstance(u, _Plan) else u.results


class _VJP:
    def __init__(self, prog, stopped: set[int]) -> None:
        self.prog = prog
        self.stopped = stopped
        self.ttypes: dict = {}     # temporary tangent key -> (shape, dtype)
        self._ntmp = 0
        self.new_rs: list[R] = []
        self.active: set[int] = set()
        self.ops: list = []          # the forward's ops, as traced
        # ops differentiated as one unit by a custom JVP (JAX's
        # ``custom_jvp``): the last op's result -> the unit's input, and
        # the ids of the inner ops, which get no rule of their own
        self.custom: dict[int, int] = {}
        self.inner: set[int] = set()

    def find_custom(self, ops, outputs) -> None:
        """Record every ``logaddexp`` unit of ``ops`` (see
        :func:`_match_logaddexp`)."""
        producer = {r: op for op in ops for r in op.results}
        uses: dict = {}
        for v in [v for op in ops for v in op.operands] + list(outputs):
            uses[v] = uses.get(v, 0) + 1
        for op in ops:
            m = _match_logaddexp(op, producer, uses, self.prog.types)
            if m is not None:
                self.custom[op.results[0]] = m[0]
                self.inner.update(id(o) for o in m[1])

    def differentiates(self, op) -> bool:
        """Whether ``op`` takes a rule of its own on the tape."""
        return op.prim not in _NO_TANGENT and id(op) not in self.inner and \
            any(self.is_active(r) for r in op.results)

    # -- values ---------------------------------------------------------

    def ttype(self, key) -> tuple[tuple[int, ...], str]:
        if key in self.ttypes:
            return self.ttypes[key]
        t = self.prog.types[key]
        return t.shape, t.dtype

    def tmp(self, shape, dtype) -> int:
        self._ntmp -= 1
        self.ttypes[self._ntmp] = (tuple(shape), dtype)
        return self._ntmp

    def vtype(self, v):
        if isinstance(v, R):
            return v.shape, v.dtype
        t = self.prog.types[v]
        return t.shape, t.dtype

    def r(self, prim, params, operands, shape, dtype) -> R:
        res = R(prim, params, list(operands), tuple(shape), dtype)
        self.new_rs.append(res)
        return res

    def full(self, shape, dtype):
        """A constant (``lax.full_like``): a broadcast literal, or the
        literal itself for a scalar."""
        if not shape:
            return Lit(dtype)
        return self.r("broadcast_in_dim", {"shape": tuple(shape),
                                           "broadcast_dimensions": ()},
                      [Lit(dtype)], shape, dtype)

    def emit(self, ctx: _Ctx, prim, params, operands, shape, dtype) -> int:
        from repro_torch.core.ir import Op
        vid = self.prog.new_value(shape, dtype)
        self.prog.add_op(Op(prim, params, list(operands), [vid]), ctx.trip)
        return vid

    def emit_multi(self, ctx: _Ctx, prim, params, operands,
                   types) -> list[int]:
        from repro_torch.core.ir import Op
        vids = [self.prog.new_value(s, d) for s, d in types]
        self.prog.add_op(Op(prim, params, list(operands), vids), ctx.trip)
        return vids

    def lit(self, dtype) -> int:
        return self.prog.new_value((), dtype)

    def val(self, ctx: _Ctx, x) -> int:
        """The vid of a primal operand in ``ctx``."""
        if isinstance(x, Lit):
            return self.lit(x.dtype)
        if isinstance(x, R):
            return self.mat(ctx, x)
        return ctx.name(x)

    def mat(self, ctx: _Ctx, r: R) -> int:
        v = ctx.find(r)
        if v is None:
            if r.prim == "stack":
                raise RuntimeError("a scan's residual stack read before "
                                   "the scan was emitted")
            ops = [self.val(ctx, o) for o in r.operands]
            v = ctx.memo[r] = self.emit(ctx, r.prim, r.params, ops,
                                        r.shape, r.dtype)
        return v

    def zeros(self, ctx: _Ctx, shape, dtype) -> int:
        return self.emit(ctx, "broadcast_in_dim",
                         {"shape": tuple(shape), "broadcast_dimensions": ()},
                         [self.lit(dtype)], shape, dtype)

    # -- activity -------------------------------------------------------

    def is_active(self, v) -> bool:
        return isinstance(v, int) and v in self.active and \
            v not in self.stopped

    def _op_activity(self, op) -> None:
        if op.prim in _NO_TANGENT:
            return
        if any(self.is_active(v) for v in op.operands):
            for r in op.results:
                if self.prog.types[r].dtype in _FLOAT:
                    self.active.add(r)

    def body_items(self, rec: ScanRecord) -> list:
        """The body's ops and nested scans' records, in order."""
        by_lo = {c.lo: c for c in rec.children}
        items, i = [], rec.lo
        while i < rec.hi:
            c = by_lo.get(i)
            if c is not None:
                items.append(c)
                i = c.hi
            else:
                items.append(self.ops[i])
                i += 1
        return items

    def scan_activity(self, rec: ScanRecord) -> None:
        for x, b in zip(rec.xs, rec.body_xs):
            if self.is_active(x):
                self.active.add(b)
        for c, b in zip(rec.carries, rec.body_carry):
            if self.is_active(c):
                self.active.add(b)
        while True:
            for it in self.body_items(rec):
                if isinstance(it, ScanRecord):
                    self.scan_activity(it)
                else:
                    self._op_activity(it)
            grew = False
            for b, out in zip(rec.body_carry, rec.carry_outs):
                if self.is_active(out) and b not in self.active:
                    self.active.add(b)
                    grew = True
            if not grew:
                break
        outs = rec.carry_outs + rec.y_outs
        for res, out in zip(rec.results, outs):
            if self.is_active(out):
                self.active.add(res)

    # -- JVP rules ------------------------------------------------------

    def jvp(self, op) -> list[Lin]:
        """Linear tape entries of one op whose result is active."""
        prim = op.prim
        act = [self.is_active(v) for v in op.operands]
        ops = op.operands
        out = op.results[0]
        shape, dtype = self.ttype(out)
        if out in self.custom:
            return _rule_logaddexp(self, self.custom[out], out, shape, dtype)
        rule = _RULES.get(prim)
        if rule is None and prim.startswith("kernel:"):
            rule = _rule_kernel
        if rule is None:
            raise NotImplementedError(
                f"no differentiation rule for prim {prim!r}")
        return rule(self, op, ops, act, out, shape, dtype)

    def maybe_bcast(self, key, shape, out) -> list[Lin]:
        """``_maybe_broadcast``: the tangent ``key`` as ``out``."""
        kshape, dtype = self.ttype(key)
        if tuple(kshape) == tuple(shape):
            return [Lin("copy", {}, [_t(key)], out)]
        if not kshape:
            return [Lin("broadcast_in_dim", {"shape": tuple(shape),
                                             "broadcast_dimensions": ()},
                        [_t(key)], out)]
        dims = tuple(i for i, (a, b) in enumerate(zip(kshape, shape))
                     if a == b)
        sq = self.tmp([kshape[i] for i in dims], dtype)
        return [Lin("reshape", {"new_sizes": tuple(kshape[i] for i in dims),
                                "dimensions": None}, [_t(key)], sq),
                Lin("broadcast_in_dim", {"shape": tuple(shape),
                                         "broadcast_dimensions": dims},
                    [_t(sq)], out)]

    def add_tangents(self, parts: list[list[Lin]], outs: list[int],
                     out: int) -> list[Lin]:
        """Sum per-operand tangent contributions as ``add_any``."""
        lins = [e for p in parts for e in p]
        if len(outs) == 1:
            for e in lins:
                if e.out == outs[0]:
                    e.out = out
            return lins
        shape, dtype = self.ttype(out)
        acc = outs[0]
        for i, o in enumerate(outs[1:]):
            nxt = out if i == len(outs) - 2 else self.tmp(shape, dtype)
            lins.append(Lin("add_any", {}, [_t(acc), _t(o)], nxt))
            acc = nxt
        return lins

    # -- transposition --------------------------------------------------

    def acc(self, ctx: _Ctx, env: dict, key, vid: int) -> None:
        if key in env:
            shape, dtype = self.ttype(key)
            vid = self.emit(ctx, "add_any", {}, [env[key], vid], shape,
                            dtype)
        env[key] = vid

    def unbroadcast(self, ctx: _Ctx, key, vid: int) -> int:
        """``_unbroadcast``: a cotangent of the result's shape summed to
        the shape of tangent ``key``."""
        shape, dtype = self.ttype(key)
        vshape = self.prog.types[vid].shape
        if tuple(vshape) == tuple(shape):
            return vid
        if not shape:
            dims = tuple(range(len(vshape)))
        else:
            dims = tuple(i for i, (a, b) in enumerate(zip(vshape, shape))
                         if a != b)
        red = tuple(d for i, d in enumerate(vshape) if i not in dims)
        vid = self.emit(ctx, "reduce_sum", {"axes": dims}, [vid], red, dtype)
        if tuple(red) != tuple(shape):
            vid = self.emit(ctx, "reshape", {"new_sizes": tuple(shape),
                                             "dimensions": None},
                            [vid], shape, dtype)
        return vid

    def transpose(self, ctx: _Ctx, tape: list[Lin], env: dict) -> None:
        for e in reversed(tape):
            if e.prim == "scan":
                self.transpose_scan(ctx, e, env)
                continue
            if isinstance(e.out, tuple):
                # a multi-result op: one cotangent (or None) per result
                cts = [env.pop(o, None) for o in e.out]
                if any(c is not None for c in cts):
                    _TRANSPOSE[e.prim](self, ctx, e, cts, env)
                continue
            ct = env.pop(e.out, None)
            if ct is None:
                continue
            _TRANSPOSE[e.prim](self, ctx, e, ct, env)

    # -- scans ----------------------------------------------------------

    def linearize(self, rec: ScanRecord, remat: bool) -> _Plan:
        """The scan's plan: its body's JVP taken symbolically (a nested
        scan's in turn, never rematerialized itself), the live part of
        its tape and the residuals its backward reads.  The body's dead
        ops leave the program with their values.

        The body's loop-invariant ops and residuals are hoisted out of
        it, as the reference's scan partial evaluation hoists them: a
        nested scan's become ops of the enclosing body (its ``lifted``
        ops), hoisted further if they do not vary there either."""
        saved, self.new_rs = self.new_rs, []
        units: list = []
        seq: list = []
        tape: list[Lin] = []
        for it in self.body_items(rec):
            if isinstance(it, ScanRecord):
                child = self.linearize(it, False)
                # its loop invariants run here, before it (their linear
                # parts stay on its tape)
                units.extend(child.lifted)
                seq.extend(child.lifted)
                units.append(child)
                seq.append(child)
                if child.lin is not None:
                    tape.append(child.lin)
                continue
            units.append(it)
            seq.append(it)
            if self.differentiates(it):
                start = len(self.new_rs)
                tape.extend(self.jvp(it))
                seq.extend(self.new_rs[start:])
        self.new_rs = saved
        body_vals = set(rec.body_carry) | set(rec.body_xs)
        variant = set(body_vals)
        hoisted: set[int] = set()
        for u in units:
            body_vals.update(_results(u))
            if isinstance(u, _Plan) or \
                    any(v in variant for v in _operands(u)):
                variant.update(_results(u))
            else:
                hoisted.add(id(u))
        # what reaches a gradient
        live_keys = {o for o in rec.carry_outs + rec.y_outs
                     if self.is_active(o)}
        live: list[Lin] = []
        for e in reversed(tape):
            if any(o in live_keys for o in _outs(e)):
                live.append(e)
                live_keys.update(a[1] for a in e.args if _is_t(a))
        live.reverse()
        needed: list = []
        seen: set = set()

        def need(x):
            if isinstance(x, Lit) or (not isinstance(x, R) and
                                      x not in body_vals):
                return
            if _key(x) in seen:
                return
            seen.add(_key(x))
            if isinstance(x, R):
                for o in x.operands:
                    need(o)
            needed.append(x)

        outside: list[int] = []
        for e in live:
            for a in e.args:
                if _is_t(a):
                    continue
                need(a)
                if isinstance(a, int) and a not in body_vals and \
                        a not in outside:
                    outside.append(a)
            if e.prim == "scan":
                # what a nested scan's forward computes around it
                for x in _hoisted_residuals(e.scan):
                    need(x)
        # what the linear ops read themselves: the residuals proper
        direct: list = []
        dseen: set = set()
        for e in live:
            for a in e.args:
                if not _is_t(a) and _key(a) in seen and _key(a) not in dseen:
                    dseen.add(_key(a))
                    direct.append(a)
        plan = _Plan(rec, remat, units, seq, live, needed, direct, seen,
                     hoisted, variant, set(), set(), [], [],
                     [c for c in dict.fromkeys(rec.consts)
                      if self.is_active(c)])

        # the forward body keeps what its carries, ys and (with the
        # residuals) the residuals read: dead primal ops go, as the
        # reference's scan partial evaluation drops them
        def keep(residuals: bool) -> set[int]:
            vals = set(rec.carry_outs) | set(rec.y_outs)
            if residuals:
                vals.update(x for x in needed if not isinstance(x, R))
            kept: set[int] = set()
            for u in reversed(units):
                if any(r in vals for r in _results(u)) or (
                        residuals and isinstance(u, _Plan) and
                        any(u.lin is e for e in live)):
                    kept.add(id(u))
                    vals.update(_operands(u))
            return kept

        plan.keep_fwd, plan.keep_res = keep(False), keep(True)
        for u in units:
            if id(u) not in plan.keep_res and not isinstance(u, _Plan):
                for r in u.results:
                    del self.prog.types[r]
        # the residuals, stacked as ys: with remat the carry in, else
        # every per-iteration value the linear ops read (the xs are
        # stacked already)
        xs = set(rec.body_xs)
        if remat:
            plan.stack_keys = list(rec.body_carry)
        else:
            plan.stack_keys = [x for x in direct if plan.r_variant(x) and
                               not (isinstance(x, int) and x in xs)]
        inputs = rec.carries + rec.xs + rec.consts
        for x in plan.stack_keys:
            shape, dtype = self.vtype(x)
            plan.stacks.append(R("stack", {}, list(inputs),
                                 (rec.length,) + tuple(shape), dtype))
        if live:
            # the entry on the enclosing tape: linear in the active
            # inputs, reading the residuals of the enclosing body
            reads: list = []
            if not remat:
                # invariant residuals (hoisted), then the xs read
                reads += [x for x in direct if not plan.r_variant(x)]
                reads += [rec.xs[rec.body_xs.index(x)] for x in direct
                          if isinstance(x, int) and x in xs]
            reads += plan.stacks + outside
            targs = [_t(v) for v in dict.fromkeys(inputs)
                     if self.is_active(v)]
            outs = tuple(r for r, o in zip(rec.results,
                                           rec.carry_outs + rec.y_outs)
                         if self.is_active(o))
            plan.lin = Lin("scan", {}, targs + reads, outs, scan=plan)
        if rec.parent is not None:
            plan.lifted = [u for u in units if id(u) in hoisted and
                           id(u) in plan.keep_res]
        return plan

    def emit_op(self, ctx: _Ctx, op) -> None:
        """Emit a forward op in ``ctx``, with values of its own there if
        the context is fresh."""
        from repro_torch.core.ir import Op
        if not ctx.fresh:
            self.prog.add_op(op, ctx.trip)
            return
        results = []
        for r in op.results:
            t = self.prog.types[r]
            results.append(self.prog.new_value(t.shape, t.dtype))
        operands = [ctx.name(v) for v in op.operands]
        for r, nv in zip(op.results, results):
            ctx.rename[r] = nv
        self.prog.add_op(Op(op.prim, op.params, operands, results),
                         ctx.trip)

    def tangent_zeros(self, ctx: _Ctx, plan: _Plan) -> None:
        """The zero tangents JAX's scan JVP instantiates for the carries
        whose init has none but whose body carry has one: dead values,
        emitted where the reference's program holds them."""
        for c, b in zip(plan.rec.carries, plan.rec.body_carry):
            if self.is_active(b) and not self.is_active(c):
                t = self.prog.types[c]
                self.zeros(ctx, t.shape, t.dtype)

    def emit_scan(self, plan: _Plan, pctx: _Ctx, with_res: bool,
                  zeros: bool = False) -> None:
        """Emit the forward scan in ``pctx``: its loop invariants there,
        then its body, in JVP order; with ``with_res`` also what its
        backward reads (under remat the carries stacked, else every
        per-iteration residual stacked as ys, the nested scans' with
        theirs); with ``zeros`` first its :meth:`tangent_zeros`."""
        rec = plan.rec
        links = self.prog.value_links
        if zeros:
            self.tangent_zeros(pctx, plan)
        body = _Ctx(pctx.trip * rec.length, pctx, pctx.fresh)
        if pctx.fresh:
            for outer, inner, off in (
                    [(c, b, 0) for c, b in zip(rec.carries, rec.body_carry)]
                    + [(x, b, 1) for x, b in zip(rec.xs, rec.body_xs)]):
                t = self.prog.types[inner]
                nb = self.prog.new_value(t.shape, t.dtype)
                links.append((pctx.name(outer), nb, off))
                body.rename[inner] = nb
        res = with_res and not plan.remat
        keep = plan.keep_res if res else plan.keep_fwd
        seq = [x for x in plan.seq if isinstance(x, R) or id(x) in keep]

        def wanted(x) -> bool:
            return res and _key(x) in plan.seen

        # loop invariants before the scan, the rest in its body, in JVP
        # order; with the residuals the invariant ones come along
        for x in seq:
            if isinstance(x, R):
                if wanted(x) and not plan.r_variant(x):
                    self.mat(pctx, x)
            elif isinstance(x, _Plan):
                if res and x.lin is not None:
                    for r in _hoisted_residuals(x):
                        if not plan.r_variant(r):
                            self.mat(pctx, r)
            elif id(x) in plan.hoisted and plan.rec.parent is None:
                self.emit_op(pctx, x)
        for x in seq:
            if isinstance(x, R):
                if wanted(x) and plan.r_variant(x):
                    self.mat(body, x)
            elif isinstance(x, _Plan):
                self.emit_scan(x, body, res and x.lin is not None)
            elif id(x) not in plan.hoisted:
                self.emit_op(body, x)
        if with_res:
            for x, st_r in zip(plan.stack_keys, plan.stacks):
                v = body.find(x) if isinstance(x, R) else body.name(x)
                t = self.prog.types[v]
                st = self.prog.new_value((rec.length,) + t.shape, t.dtype)
                links.append((st, v, 1))
                pctx.memo[st_r] = st
        if pctx.fresh:
            n = len(rec.carries)
            for i, r in enumerate(rec.results):
                t = self.prog.types[r]
                nr = self.prog.new_value(t.shape, t.dtype)
                pctx.rename[r] = nr
                if i < n:
                    links.append((body.name(rec.carry_outs[i]), nr, 0))
                    links.append((body.name(rec.body_carry[i]), nr, 0))
                else:
                    links.append((nr, body.name(rec.y_outs[i - n]), 1))

    def transpose_scan(self, ctx: _Ctx, e: Lin, env: dict) -> None:
        """The backward scan, as JAX's scan transpose: the carries'
        cotangents (zeros where none reached them) and one accumulator
        per differentiated const (zeros in, added to in the body) are
        its carries, the stacked ys' cotangents and the residual stacks
        its xs; the forward xs' cotangents come out stacked."""
        plan: _Plan | None = e.scan
        if plan is None:
            return
        rec = plan.rec
        types = self.prog.types
        links = self.prog.value_links
        n_carry = len(rec.carries)
        init = []
        for i in range(n_carry):
            res = rec.results[i]
            if not self.is_active(rec.carry_outs[i]):
                init.append(None)
                continue
            ct = env.pop(res, None)
            if ct is None:
                ct = self.zeros(ctx, types[res].shape, types[res].dtype)
            init.append(ct)
        y_cts = [env.pop(rec.results[n_carry + j], None)
                 if self.is_active(y) else None
                 for j, y in enumerate(rec.y_outs)]
        c_init = [self.zeros(ctx, types[c].shape, types[c].dtype)
                  for c in plan.consts]
        body = _Ctx(ctx.trip * rec.length, ctx, fresh=True)

        def carried(c):
            t = types[c]
            b = self.prog.new_value(t.shape, t.dtype)
            links.append((c, b, 0))
            return b

        bconst = [carried(c) for c in c_init]
        bcarry = [None if c is None else carried(c) for c in init]
        bys = []
        for y, ct in zip(rec.y_outs, y_cts):
            if ct is None:
                continue
            t = types[ct]
            b = self.prog.new_value(t.shape[1:], t.dtype)
            links.append((ct, b, 1))
            bys.append((y, b))
        # stacked inputs of the backward body: residual stacks, and the
        # forward xs it reads, each at its first read
        for key, st_r in zip(plan.stack_keys, plan.stacks):
            st = self.val(ctx, st_r)
            shape, dtype = self.vtype(key)
            b = self.prog.new_value(shape, dtype)
            links.append((st, b, 1))
            if isinstance(key, R):
                body.memo[key] = b
            else:
                body.rename[key] = b

        def slice_of(x, bx):
            t = types[bx]
            b = self.prog.new_value(t.shape, t.dtype)
            links.append((ctx.name(x), b, 1))
            return b

        for x, bx in zip(rec.xs, rec.body_xs):
            body.lazy[bx] = lambda x=x, bx=bx: slice_of(x, bx)
        if plan.remat:
            # the recomputed forward and every residual the live linear
            # ops read, as the reference's known (recomputed) body
            self._recompute(body, plan)
        else:
            # what the linear body computes before any transposition
            for e in plan.tape:
                if e.prim == "scan":
                    self.tangent_zeros(body, e.scan)
        # a const's accumulator takes each contribution as it comes;
        # under remat the recomputed body's contributions are summed
        # first and added to it at the end, as the transpose of the
        # reference's checkpointed body returns them
        benv: dict = {} if plan.remat else dict(zip(plan.consts, bconst))
        for out, b in zip(rec.carry_outs, bcarry):
            if b is not None:
                self.acc(body, benv, out, b)
        for y, b in bys:
            self.acc(body, benv, y, b)
        self.transpose(body, plan.tape, benv)
        const_out = []
        for c, b in zip(plan.consts, bconst):
            ct = benv.pop(c, None)
            if plan.remat and ct is not None:
                ct = self.emit(body, "add_any", {}, [b, ct], types[b].shape,
                               types[b].dtype)
            const_out.append(b if ct is None else ct)
        carry_out = []
        for i, bc in enumerate(rec.body_carry):
            if bcarry[i] is None:
                continue
            ct = benv.pop(bc, None)
            if ct is None:
                ct = self.zeros(body, types[bc].shape, types[bc].dtype)
            carry_out.append((i, ct))
        ys = []
        for x, bx in zip(rec.xs, rec.body_xs):
            if not self.is_active(bx):
                continue
            ct = benv.pop(bx, None)
            if ct is None:
                ct = self.zeros(body, types[bx].shape, types[bx].dtype)
            ys.append((x, ct))
        for c, ct, b in zip(plan.consts, const_out, bconst):
            res = self.prog.new_value(types[ct].shape, types[ct].dtype)
            links.append((ct, res, 0))
            links.append((b, res, 0))
            self.acc(ctx, env, c, res)
        for i, ct in carry_out:
            res = self.prog.new_value(types[ct].shape, types[ct].dtype)
            links.append((ct, res, 0))
            links.append((bcarry[i], res, 0))
            if self.is_active(rec.carries[i]):
                self.acc(ctx, env, rec.carries[i], res)
        for x, ct in ys:
            t = types[ct]
            res = self.prog.new_value((rec.length,) + t.shape, t.dtype)
            links.append((res, ct, 1))
            self.acc(ctx, env, x, res)

    def _recompute(self, body: _Ctx, plan: _Plan) -> None:
        """Emit the forward body's ops the backward body reads, and the
        residuals, in the forward's JVP order (remat); a nested scan
        the backward differentiates comes with its residuals."""
        producer = {r: u for u in plan.units for r in _results(u)}
        want: set[int] = set()

        def walk(x):
            if isinstance(x, R):
                for o in x.operands:
                    walk(o)
            elif isinstance(x, int) and x in producer and x not in want:
                want.add(x)
                for o in _operands(producer[x]):
                    walk(o)

        for x in plan.needed:
            walk(x)
        rs = {_key(x) for x in plan.needed if isinstance(x, R)}
        for x in plan.seq:
            if isinstance(x, R):
                if _key(x) in rs:
                    self.mat(body, x)
            elif isinstance(x, _Plan):
                diff = any(x.lin is e for e in plan.tape)
                if diff or any(r in want for r in x.rec.results):
                    self.emit_scan(x, body, diff, zeros=diff)
            elif any(r in want for r in x.results):
                self.emit_op(body, x)


def _hoisted_residuals(plan: _Plan) -> list:
    """The loop-invariant residuals a nested scan's forward reads: they
    are emitted around it."""
    if plan.remat:
        return []
    return [x for x in plan.needed if isinstance(x, R) and
            x.prim != "stack" and not plan.r_variant(x)]


# ---------------------------------------------------------------------------
# JVP rules: (vjp, op, operands, active, out, shape, dtype) -> tape entries
# ---------------------------------------------------------------------------


def _rule_linear_unary(vjp, op, ops, act, out, shape, dtype):
    return [Lin(op.prim, dict(op.params), [_t(ops[0])] + ops[1:], out)]


def _rule_convert(vjp, op, ops, act, out, shape, dtype):
    return [Lin("convert_element_type", dict(op.params), [_t(ops[0])], out)]


def _rule_add(vjp, op, ops, act, out, shape, dtype):
    if act[0] and act[1]:
        return [Lin("add", {}, [_t(ops[0]), _t(ops[1])], out)]
    return vjp.maybe_bcast(ops[0] if act[0] else ops[1], shape, out)


def _rule_sub(vjp, op, ops, act, out, shape, dtype):
    if act[0] and act[1]:
        return [Lin("sub", {}, [_t(ops[0]), _t(ops[1])], out)]
    if act[0]:
        return vjp.maybe_bcast(ops[0], shape, out)
    yshape, _ = vjp.ttype(ops[1])
    neg = vjp.tmp(yshape, dtype)
    return [Lin("neg", {}, [_t(ops[1])], neg)] + \
        vjp.maybe_bcast(neg, shape, out)


def _bshape(a, b):
    if not a:
        return tuple(b)
    if not b:
        return tuple(a)
    return tuple(max(x, y) for x, y in zip(a, b))


def _rule_mul(vjp, op, ops, act, out, shape, dtype):
    parts, outs = [], []
    if act[0]:
        o = vjp.tmp(_bshape(vjp.ttype(ops[0])[0], vjp.vtype(ops[1])[0]),
                    dtype)
        parts.append([Lin("mul", {}, [_t(ops[0]), ops[1]], o)])
        outs.append(o)
    if act[1]:
        o = vjp.tmp(_bshape(vjp.vtype(ops[0])[0], vjp.ttype(ops[1])[0]),
                    dtype)
        parts.append([Lin("mul", {}, [ops[0], _t(ops[1])], o)])
        outs.append(o)
    return vjp.add_tangents(parts, outs, out)


def _rule_div(vjp, op, ops, act, out, shape, dtype):
    parts, outs = [], []
    x, y = ops
    if act[0]:
        o = vjp.tmp(_bshape(vjp.ttype(x)[0], vjp.vtype(y)[0]), dtype)
        parts.append([Lin("div", {}, [_t(x), y], o)])
        outs.append(o)
    if act[1]:
        yshape = vjp.ttype(y)[0]
        xshape = vjp.vtype(x)[0]
        pw = vjp.r("integer_pow", {"y": -2}, [y], yshape, dtype)
        n = vjp.tmp(yshape, dtype)
        m = vjp.tmp(_bshape(yshape, xshape), dtype)
        o = vjp.tmp(_bshape(_bshape(yshape, xshape), yshape), dtype)
        parts.append([Lin("neg", {}, [_t(y)], n),
                      Lin("mul", {}, [_t(n), x], m),
                      Lin("mul", {}, [_t(m), pw], o)])
        outs.append(o)
    return vjp.add_tangents(parts, outs, out)


def _rule_neg(vjp, op, ops, act, out, shape, dtype):
    return [Lin("neg", {}, [_t(ops[0])], out)]


def _rule_exp(vjp, op, ops, act, out, shape, dtype):
    return [Lin("mul", {}, [_t(ops[0]), out], out)]


def _rule_log(vjp, op, ops, act, out, shape, dtype):
    return [Lin("div", {}, [_t(ops[0]), ops[0]], out)]


def _rule_rsqrt(vjp, op, ops, act, out, shape, dtype):
    d = vjp.r("div", {}, [out, ops[0]], shape, dtype)
    m = vjp.r("mul", {}, [Lit(dtype), d], shape, dtype)
    return [Lin("mul", {}, [_t(ops[0]), m], out)]


def _rule_sqrt(vjp, op, ops, act, out, shape, dtype):
    d = vjp.r("div", {}, [Lit(dtype), out], shape, dtype)
    return [Lin("mul", {}, [_t(ops[0]), d], out)]


def _rule_logistic(vjp, op, ops, act, out, shape, dtype):
    s = vjp.r("sub", {}, [Lit(dtype), out], shape, dtype)
    m = vjp.r("mul", {}, [out, s], shape, dtype)
    return [Lin("mul", {}, [_t(ops[0]), m], out)]


def _rule_square(vjp, op, ops, act, out, shape, dtype):
    m = vjp.r("mul", {}, [Lit(dtype), ops[0]], shape, dtype)
    return [Lin("mul", {}, [_t(ops[0]), m], out)]


def _rule_integer_pow(vjp, op, ops, act, out, shape, dtype):
    y = op.params["y"]
    pw = vjp.r("integer_pow", {"y": y - 1}, [ops[0]], shape, dtype)
    m = vjp.r("mul", {}, [Lit(dtype), pw], shape, dtype)
    return [Lin("mul", {}, [_t(ops[0]), m], out)]


def _rule_abs(vjp, op, ops, act, out, shape, dtype):
    ge = vjp.r("ge", {}, [ops[0], Lit(dtype)], shape, "bool")
    n = vjp.tmp(shape, dtype)
    return [Lin("neg", {}, [_t(ops[0])], n),
            Lin("select_n", {}, [ge, _t(n), _t(ops[0])], out)]


def _rule_reduce_max(vjp, op, ops, act, out, shape, dtype):
    axes = tuple(op.params["axes"])
    xshape = vjp.vtype(ops[0])[0]
    kshape = tuple(1 if i in axes else d for i, d in enumerate(xshape))
    rs = vjp.r("reshape", {"new_sizes": kshape, "dimensions": None}, [out],
               kshape, dtype)
    eq = vjp.r("eq", {}, [ops[0], rs], xshape, "bool")
    loc = vjp.r("convert_element_type",
                {"new_dtype": dtype, "weak_type": False}, [eq], xshape,
                dtype)
    cnt = vjp.r("reduce_sum", {"axes": axes}, [loc], shape, dtype)
    m = vjp.tmp(xshape, dtype)
    s = vjp.tmp(shape, dtype)
    return [Lin("mul", {}, [_t(ops[0]), loc], m),
            Lin("reduce_sum", {"axes": axes}, [_t(m)], s),
            Lin("div", {}, [_t(s), cnt], out)]


def _rule_log1p(vjp, op, ops, act, out, shape, dtype):
    r = vjp.r("add", {}, [ops[0], Lit(dtype)], shape, dtype)
    return [Lin("div", {}, [_t(ops[0]), r], out)]


def _rule_tanh(vjp, op, ops, act, out, shape, dtype):
    # JAX's: (g + g * ans) * (1 - ans)
    s = vjp.r("sub", {}, [Lit(dtype), out], shape, dtype)
    m, a = vjp.tmp(shape, dtype), vjp.tmp(shape, dtype)
    return [Lin("mul", {}, [_t(ops[0]), out], m),
            Lin("add", {}, [_t(ops[0]), _t(m)], a),
            Lin("mul", {}, [_t(a), s], out)]


def _rule_max(vjp, op, ops, act, out, shape, dtype):
    # JAX's ``_balanced_eq`` weights, per differentiated side: 1 where
    # that side is the result, 1/2 where the two tie, else 0
    def balanced(x, y):
        ex = vjp.r("eq", {}, [x, out], shape, "bool")
        hit = vjp.r("select_n", {}, [ex, vjp.full(shape, dtype),
                                     vjp.full(shape, dtype)], shape, dtype)
        ey = vjp.r("eq", {}, [y, out], shape, "bool")
        tie = vjp.r("select_n", {}, [ey, vjp.full(shape, dtype),
                                     vjp.full(shape, dtype)], shape, dtype)
        return vjp.r("div", {}, [hit, tie], shape, dtype)

    parts, outs = [], []
    for i, (x, y) in enumerate(((ops[0], ops[1]), (ops[1], ops[0]))):
        if not act[i]:
            continue
        o = vjp.tmp(_bshape(vjp.ttype(x)[0], shape), dtype)
        parts.append([Lin("mul", {}, [_t(x), balanced(x, y)], o)])
        outs.append(o)
    return vjp.add_tangents(parts, outs, out)


def _rule_pad(vjp, op, ops, act, out, shape, dtype):
    if act[1]:
        raise NotImplementedError("a gradient through a pad's value")
    return [Lin("pad", dict(op.params), [_t(ops[0]), Lit(dtype)], out)]


def _rule_logaddexp(vjp, x1, out, shape, dtype):
    """JAX's ``custom_jvp`` of ``logaddexp(x1, c)`` for a constant ``c``
    (``jax.nn.softplus``): ``t1 * exp(ri(x1) - ri(out)) + t2 * exp(ri(c)
    - ri(out))``, ``ri`` the replacement of +inf by 0, ``t2`` the
    constant's instantiated zero tangent."""
    def ri(v, vshape):
        eq = vjp.r("eq", {}, [v, Lit(dtype)], vshape, "bool")
        return vjp.r("select_n", {}, [eq, v, vjp.full(vshape, dtype)],
                     vshape, dtype)

    xshape = vjp.vtype(x1)[0]
    d1 = vjp.r("sub", {}, [ri(x1, xshape), ri(out, shape)], shape, dtype)
    c1 = vjp.r("exp", {}, [d1], shape, dtype)
    d2 = vjp.r("sub", {}, [ri(Lit(dtype), ()), ri(out, shape)], shape,
               dtype)
    c2 = vjp.r("exp", {}, [d2], shape, dtype)
    k = vjp.r("mul", {}, [Lit(dtype), c2], shape, dtype)
    m = vjp.tmp(shape, dtype)
    return [Lin("mul", {}, [_t(x1), c1], m),
            Lin("add", {}, [_t(m), k], out)]


def _match_logaddexp(op, producer, uses, types):
    """``(x1, interior ops)`` when ``op`` ends ``logaddexp(x1, c)`` for a
    scalar constant ``c`` in ``jnp.logaddexp``'s steps, else ``None``:
    ``select_n(ne(d, d), max(x1, c) + log1p(exp(-|d|)), x1 + c)`` with
    ``d = x1 - c``, every inner value read inside the group only."""
    def prod(v, prim):
        p = producer.get(v)
        return p if p is not None and p.prim == prim else None

    def const(v):
        return v not in producer and not types[v].shape

    if op.prim != "select_n" or len(op.operands) != 3:
        return None
    pred, big, nan = op.operands
    ne = prod(pred, "ne")
    if ne is None or ne.operands[0] != ne.operands[1]:
        return None
    sub = prod(ne.operands[0], "sub")
    if sub is None or not const(sub.operands[1]):
        return None
    x1 = sub.operands[0]
    s = prod(nan, "add")
    top = prod(big, "add")
    if s is None or top is None or s.operands[0] != x1 or \
            not const(s.operands[1]):
        return None
    mx = prod(top.operands[0], "max")
    lg = prod(top.operands[1], "log1p")
    if mx is None or lg is None or mx.operands[0] != x1 or \
            not const(mx.operands[1]):
        return None
    chain = [lg]
    for prim in ("exp", "neg", "abs"):
        chain.append(prod(chain[-1].operands[0], prim))
        if chain[-1] is None:
            return None
    if chain[-1].operands[0] != sub.results[0]:
        return None
    inner = [mx, sub, ne, s, *chain[::-1], top]
    # d is read by ne twice and by abs; every other value once
    if uses[sub.results[0]] != 3 or any(
            uses[o.results[0]] != 1 for o in inner if o is not sub):
        return None
    return x1, inner


def _rule_dot_general(vjp, op, ops, act, out, shape, dtype):
    parts, outs = [], []
    for i in (0, 1):
        if not act[i]:
            continue
        o = vjp.tmp(shape, dtype)
        args = [_t(ops[0]), ops[1]] if i == 0 else [ops[0], _t(ops[1])]
        parts.append([Lin("dot_general", dict(op.params), args, o)])
        outs.append(o)
    return vjp.add_tangents(parts, outs, out)


def _rule_concatenate(vjp, op, ops, act, out, shape, dtype):
    args = []
    for v, a in zip(ops, act):
        if a:
            args.append(_t(v))
        else:
            s, d = vjp.vtype(v)
            args.append(vjp.r("broadcast_in_dim",
                              {"shape": tuple(s),
                               "broadcast_dimensions": ()},
                              [Lit(d)], s, d))
    return [Lin("concatenate", dict(op.params), args, out)]


def _rule_select_n(vjp, op, ops, act, out, shape, dtype):
    args: list = [ops[0]]
    zeros = None
    for v, a in zip(ops[1:], act[1:]):
        if a:
            args.append(_t(v))
            continue
        if zeros is None:
            zeros = vjp.r("broadcast_in_dim",
                          {"shape": tuple(shape), "broadcast_dimensions": ()},
                          [Lit(dtype)], shape, dtype)
        args.append(zeros)
    return [Lin("select_n", {}, args, out)]


def _rule_gather(vjp, op, ops, act, out, shape, dtype):
    if act[1]:
        raise NotImplementedError("a gradient through gather indices")
    return [Lin("gather", dict(op.params), [_t(ops[0]), ops[1]], out)]


def _rule_top_k(vjp, op, ops, act, out, shape, dtype):
    # JAX's ``_top_k_jvp``: the indices reshaped with a unit index
    # vector dim (a residual), then a gather of the tangent at them, one
    # element along ``axis`` and every other dim a batching dim; the
    # indices carry no tangent
    axis = op.params["axis"]
    ishape, idtype = vjp.vtype(op.results[1])
    rank = len(ishape)
    gi = vjp.r("reshape", {"new_sizes": tuple(ishape) + (1,),
                           "dimensions": None}, [op.results[1]],
               tuple(ishape) + (1,), idtype)
    batch = tuple(i for i in range(rank) if i != axis)
    dn = GatherDimensionNumbers(
        offset_dims=(), collapsed_slice_dims=(axis,),
        start_index_map=(axis,), operand_batching_dims=batch,
        start_indices_batching_dims=batch)
    return [Lin("gather", {"dimension_numbers": dn,
                           "slice_sizes": (1,) * rank},
                [_t(ops[0]), gi], out)]


def _rule_scatter_add(vjp, op, ops, act, out, shape, dtype):
    # JAX's ``_scatter_add_jvp``: linear in the operand and the updates,
    # a side without a tangent instantiated as zeros (a residual); the
    # indices carry none
    if act[1]:
        raise NotImplementedError("a gradient through scatter indices")
    args: list = []
    for v, a in ((ops[0], act[0]), (ops[2], act[2])):
        if a:
            args.append(_t(v))
        else:
            s, d = vjp.vtype(v)
            args.append(vjp.full(s, d))
    return [Lin("scatter-add", dict(op.params), [args[0], ops[1], args[1]],
                out)]


def _rule_split(vjp, op, ops, act, out, shape, dtype):
    # linear, one tangent per piece
    return [Lin("split", dict(op.params), [_t(ops[0])], tuple(op.results))]


def _rule_kernel(vjp, op, ops, act, out, shape, dtype):
    from repro_torch.kernels import registry
    spec = registry.spec_for_prim(op.prim)
    bwd = registry.KERNELS.get(spec.name + "_bwd") if spec else None
    if bwd is None:
        raise NotImplementedError(
            f"no backward for the fused kernel {op.prim!r}")
    return [Lin(bwd.prim, dict(op.params, kernel=bwd.name),
                [_t(v) if a else v for v, a in zip(ops, act)] + list(ops),
                out)]


_RULES = {
    "add": _rule_add, "add_any": _rule_add, "sub": _rule_sub,
    "mul": _rule_mul, "div": _rule_div, "neg": _rule_neg,
    "exp": _rule_exp, "log": _rule_log, "rsqrt": _rule_rsqrt,
    "sqrt": _rule_sqrt, "logistic": _rule_logistic,
    "square": _rule_square, "integer_pow": _rule_integer_pow,
    "abs": _rule_abs, "reduce_max": _rule_reduce_max,
    "log1p": _rule_log1p, "tanh": _rule_tanh, "max": _rule_max,
    "min": _rule_max, "pad": _rule_pad,
    "reduce_sum": _rule_linear_unary, "broadcast_in_dim": _rule_linear_unary,
    "reshape": _rule_linear_unary, "transpose": _rule_linear_unary,
    "squeeze": _rule_linear_unary, "slice": _rule_linear_unary,
    "convert_element_type": _rule_convert,
    "dot_general": _rule_dot_general, "concatenate": _rule_concatenate,
    "select_n": _rule_select_n, "gather": _rule_gather,
    "top_k": _rule_top_k, "scatter-add": _rule_scatter_add,
    "cumsum": _rule_linear_unary, "split": _rule_split,
}


# ---------------------------------------------------------------------------
# transpose rules: (vjp, ctx, entry, ct vid, env)
# ---------------------------------------------------------------------------


def _tr_copy(vjp, ctx, e, ct, env):
    vjp.acc(ctx, env, e.args[0][1], ct)


def _tr_neg(vjp, ctx, e, ct, env):
    key = e.args[0][1]
    shape, dtype = vjp.ttype(key)
    vjp.acc(ctx, env, key, vjp.emit(ctx, "neg", {}, [ct], shape, dtype))


def _tr_add(vjp, ctx, e, ct, env):
    for a in e.args:
        if _is_t(a):
            vjp.acc(ctx, env, a[1], vjp.unbroadcast(ctx, a[1], ct))


def _tr_sub(vjp, ctx, e, ct, env):
    x, y = e.args
    if _is_t(x):
        vjp.acc(ctx, env, x[1], vjp.unbroadcast(ctx, x[1], ct))
    if _is_t(y):
        t = vjp.prog.types[ct]
        n = vjp.emit(ctx, "neg", {}, [ct], t.shape, t.dtype)
        vjp.acc(ctx, env, y[1], vjp.unbroadcast(ctx, y[1], n))


def _tr_mul(vjp, ctx, e, ct, env):
    x, y = e.args
    t = vjp.prog.types[ct]
    if _is_t(x):
        other = vjp.val(ctx, y)
        shape = _bshape(t.shape, vjp.prog.types[other].shape)
        m = vjp.emit(ctx, "mul", {}, [ct, other], shape, t.dtype)
        vjp.acc(ctx, env, x[1], vjp.unbroadcast(ctx, x[1], m))
    else:
        other = vjp.val(ctx, x)
        shape = _bshape(vjp.prog.types[other].shape, t.shape)
        m = vjp.emit(ctx, "mul", {}, [other, ct], shape, t.dtype)
        vjp.acc(ctx, env, y[1], vjp.unbroadcast(ctx, y[1], m))


def _tr_div(vjp, ctx, e, ct, env):
    x, y = e.args
    t = vjp.prog.types[ct]
    other = vjp.val(ctx, y)
    d = vjp.emit(ctx, "div", {}, [ct, other], t.shape, t.dtype)
    vjp.acc(ctx, env, x[1], vjp.unbroadcast(ctx, x[1], d))


def _tr_convert(vjp, ctx, e, ct, env):
    key = e.args[0][1]
    shape, dtype = vjp.ttype(key)
    if vjp.prog.types[ct].dtype != dtype:
        ct = vjp.emit(ctx, "convert_element_type",
                      {"new_dtype": dtype, "weak_type": False}, [ct], shape,
                      dtype)
    vjp.acc(ctx, env, key, ct)


def _tr_reduce_sum(vjp, ctx, e, ct, env):
    key = e.args[0][1]
    shape, dtype = vjp.ttype(key)
    axes = set(e.params["axes"])
    bdims = tuple(i for i in range(len(shape)) if i not in axes)
    vjp.acc(ctx, env, key, vjp.emit(
        ctx, "broadcast_in_dim", {"shape": tuple(shape),
                                  "broadcast_dimensions": bdims},
        [ct], shape, dtype))


def _tr_broadcast_in_dim(vjp, ctx, e, ct, env):
    key = e.args[0][1]
    shape, dtype = vjp.ttype(key)
    out_shape = e.params["shape"]
    bd = list(e.params["broadcast_dimensions"])
    unit = [i for i, s in enumerate(shape) if s == 1]
    bdims = [d for i, d in enumerate(bd) if i not in unit]
    axes = tuple(i for i in range(len(out_shape)) if i not in bdims)
    v = ct
    if axes:
        red = tuple(s for i, s in enumerate(out_shape) if i not in axes)
        v = vjp.emit(ctx, "reduce_sum", {"axes": axes}, [v], red, dtype)
    if unit:
        kept = tuple(i for i in range(len(shape)) if i not in unit)
        v = vjp.emit(ctx, "broadcast_in_dim",
                     {"shape": tuple(shape), "broadcast_dimensions": kept},
                     [v], shape, dtype)
    vjp.acc(ctx, env, key, v)


def _tr_reshape(vjp, ctx, e, ct, env):
    key = e.args[0][1]
    shape, dtype = vjp.ttype(key)
    if tuple(vjp.prog.types[ct].shape) != tuple(shape):
        ct = vjp.emit(ctx, "reshape", {"new_sizes": tuple(shape),
                                       "dimensions": None}, [ct], shape,
                      dtype)
    vjp.acc(ctx, env, key, ct)


def _tr_transpose(vjp, ctx, e, ct, env):
    key = e.args[0][1]
    shape, dtype = vjp.ttype(key)
    perm = tuple(int(i) for i in np.argsort(e.params["permutation"]))
    vjp.acc(ctx, env, key, vjp.emit(ctx, "transpose", {"permutation": perm},
                                    [ct], shape, dtype))


def _tr_squeeze(vjp, ctx, e, ct, env):
    key = e.args[0][1]
    shape, dtype = vjp.ttype(key)
    dims = set(e.params["dimensions"])
    kept = tuple(i for i in range(len(shape)) if i not in dims)
    vjp.acc(ctx, env, key, vjp.emit(
        ctx, "broadcast_in_dim", {"shape": tuple(shape),
                                  "broadcast_dimensions": kept},
        [ct], shape, dtype))


def _tr_slice(vjp, ctx, e, ct, env):
    key = e.args[0][1]
    shape, dtype = vjp.ttype(key)
    start = e.params["start_indices"]
    strides = e.params.get("strides") or (1,) * len(shape)
    out = vjp.prog.types[ct].shape
    cfg = []
    for i, n in enumerate(shape):
        real = start[i] + (0 if out[i] == 0 else
                           1 + (out[i] - 1) * strides[i])
        cfg.append((start[i], n - real, strides[i] - 1))
    vjp.acc(ctx, env, key, vjp.emit(
        ctx, "pad", {"padding_config": tuple(cfg)}, [ct, vjp.lit(dtype)],
        shape, dtype))


def _tr_pad(vjp, ctx, e, ct, env):
    # JAX's: the padding undone by a negative pad, then the interior
    # dropped by a strided slice
    key = e.args[0][1]
    shape, dtype = vjp.ttype(key)
    cfg = e.params["padding_config"]
    full = vjp.prog.types[ct].shape
    ushape = tuple(n - lo - hi for n, (lo, hi, _) in zip(full, cfg))
    u = vjp.emit(ctx, "pad", {"padding_config": tuple(
        (-lo, -hi, 0) for lo, hi, _ in cfg)}, [ct, vjp.lit(dtype)], ushape,
        dtype)
    vjp.acc(ctx, env, key, vjp.emit(
        ctx, "slice", {"start_indices": (0,) * len(shape),
                       "limit_indices": ushape,
                       "strides": tuple(i + 1 for _, _, i in cfg)},
        [u], shape, dtype))


def _tr_concatenate(vjp, ctx, e, ct, env):
    dim = e.params["dimension"]
    types = []
    for a in e.args:
        s, d = vjp.ttype(a[1]) if _is_t(a) else vjp.vtype(a)
        types.append((s, d))
    parts = vjp.emit_multi(ctx, "split",
                           {"sizes": tuple(s[dim] for s, _ in types),
                            "axis": dim}, [ct], types)
    for a, v in zip(e.args, parts):
        if _is_t(a):
            vjp.acc(ctx, env, a[1], v)


def _tr_split(vjp, ctx, e, cts, env):
    # JAX's: the pieces' cotangents concatenated, zeros instantiated for
    # those without one
    key = e.args[0][1]
    shape, dtype = vjp.ttype(key)
    parts = []
    for o, ct in zip(e.out, cts):
        if ct is None:
            ct = vjp.zeros(ctx, *vjp.ttype(o))
        parts.append(ct)
    vjp.acc(ctx, env, key, vjp.emit(
        ctx, "concatenate", {"dimension": e.params["axis"]}, parts, shape,
        dtype))


def _tr_cumsum(vjp, ctx, e, ct, env):
    # JAX's: the cumulative sum the other way
    key = e.args[0][1]
    shape, dtype = vjp.ttype(key)
    vjp.acc(ctx, env, key, vjp.emit(
        ctx, "cumsum", {"axis": e.params["axis"],
                        "reverse": not e.params["reverse"]}, [ct], shape,
        dtype))


def _tr_dot_general(vjp, ctx, e, ct, env):
    (lc, rc), (lb, rb) = e.params["dimension_numbers"]
    x, y = e.args
    if _is_t(x):
        y_v = vjp.val(ctx, y)
        xs, dtype = vjp.ttype(x[1])
        v = _dot_transpose_lhs(vjp, ctx, ct, xs, y_v, lc, rc, lb, rb,
                               False, dtype)
        vjp.acc(ctx, env, x[1], v)
    else:
        x_v = vjp.val(ctx, x)
        ys, dtype = vjp.ttype(y[1])
        v = _dot_transpose_lhs(vjp, ctx, ct, ys, x_v, rc, lc, rb, lb,
                               True, dtype)
        vjp.acc(ctx, env, y[1], v)


def _ranges_like(*xs):
    start = 0
    for x in xs:
        yield list(range(start, start + len(x)))
        start += len(x)


def _dot_transpose_lhs(vjp, ctx, g, x_shape, y, x_contract, y_contract,
                       x_batch, y_batch, swap_ans, dtype):
    """JAX's ``_dot_general_transpose_lhs``: the cotangent of the lhs."""
    x_ndim = len(x_shape)
    y_shape = vjp.prog.types[y].shape
    x_kept = [i for i in range(x_ndim)
              if i not in x_contract and i not in x_batch]
    y_kept = [i for i in range(len(y_shape))
              if i not in y_contract and i not in y_batch]
    if swap_ans:
        ans_batch, ans_y, _ = _ranges_like(x_batch, y_kept, x_kept)
    else:
        ans_batch, _, ans_y = _ranges_like(x_batch, x_kept, y_kept)
    dims = ((tuple(ans_y), tuple(y_kept)), (tuple(ans_batch), tuple(y_batch)))
    x_contract_sorted_by_y = list(np.take(x_contract, np.argsort(y_contract)))
    out_axes = np.argsort(list(x_batch) + x_kept + x_contract_sorted_by_y)
    g_shape = vjp.prog.types[g].shape
    dshape = [g_shape[i] for i in ans_batch] + \
        [g_shape[i] for i in range(len(g_shape))
         if i not in ans_y and i not in ans_batch] + \
        [y_shape[i] for i in range(len(y_shape))
         if i not in y_kept and i not in y_batch]
    v = vjp.emit(ctx, "dot_general",
                 {"dimension_numbers": dims, "precision": None,
                  "preferred_element_type": dtype}, [g, y], dshape, dtype)
    perm = tuple(int(i) for i in out_axes)
    if perm != tuple(range(len(perm))):
        v = vjp.emit(ctx, "transpose", {"permutation": perm}, [v],
                     x_shape, dtype)
    return v


def _tr_select_n(vjp, ctx, e, ct, env):
    pred = vjp.val(ctx, e.args[0])
    t = vjp.prog.types[ct]
    cases = e.args[1:]
    zeros = None
    for i, a in enumerate(cases):
        if not _is_t(a):
            continue
        if zeros is None:
            zeros = vjp.zeros(ctx, t.shape, t.dtype)
        ops = [pred] + [ct if j == i else zeros for j in range(len(cases))]
        vjp.acc(ctx, env, a[1], vjp.emit(ctx, "select_n", {}, ops, t.shape,
                                         t.dtype))


def _tr_gather(vjp, ctx, e, ct, env):
    key = e.args[0][1]
    shape, dtype = vjp.ttype(key)
    idx = vjp.val(ctx, e.args[1])
    dn = e.params["dimension_numbers"]
    sdn = ScatterDimensionNumbers(
        update_window_dims=tuple(dn.offset_dims),
        inserted_window_dims=tuple(dn.collapsed_slice_dims),
        scatter_dims_to_operand_dims=tuple(dn.start_index_map),
        operand_batching_dims=tuple(dn.operand_batching_dims),
        scatter_indices_batching_dims=tuple(dn.start_indices_batching_dims))
    zeros = vjp.zeros(ctx, shape, dtype)
    vjp.acc(ctx, env, key, vjp.emit(
        ctx, "scatter-add",
        {"dimension_numbers": sdn, "indices_are_sorted": False,
         "unique_indices": False, "mode": None, "update_jaxpr": None,
         "update_consts": ()},
        [zeros, idx, ct], shape, dtype))


def _tr_scatter_add(vjp, ctx, e, ct, env):
    # JAX's ``_scatter_add_transpose_rule``: the operand takes the
    # cotangent itself, the updates its gather at the indices
    operand, idx, upd = e.args
    if _is_t(operand):
        vjp.acc(ctx, env, operand[1], ct)
    if not _is_t(upd):
        return
    shape, dtype = vjp.ttype(upd[1])
    dn = e.params["dimension_numbers"]
    gdn = GatherDimensionNumbers(
        offset_dims=tuple(dn.update_window_dims),
        collapsed_slice_dims=tuple(dn.inserted_window_dims),
        start_index_map=tuple(dn.scatter_dims_to_operand_dims),
        operand_batching_dims=tuple(dn.operand_batching_dims),
        start_indices_batching_dims=tuple(dn.scatter_indices_batching_dims))
    window = iter(dn.update_window_dims)
    sizes = tuple(1 if i in dn.inserted_window_dims or
                  i in dn.operand_batching_dims else shape[next(window)]
                  for i in range(len(vjp.prog.types[ct].shape)))
    vjp.acc(ctx, env, upd[1], vjp.emit(
        ctx, "gather", {"dimension_numbers": gdn, "slice_sizes": sizes},
        [ct, vjp.val(ctx, idx)], shape, dtype))


def _tr_add_any(vjp, ctx, e, ct, env):
    for a in e.args:
        vjp.acc(ctx, env, a[1], ct)


def _tr_kernel_bwd(vjp, ctx, e, ct, env):
    n = len(e.args) // 2
    lin, prim_ops = e.args[:n], e.args[n:]
    operands = [vjp.val(ctx, v) for v in prim_ops] + [ct]
    types = [vjp.vtype(v) for v in prim_ops]
    params = {k: v for k, v in e.params.items()}
    cts = vjp.emit_multi(ctx, e.prim, params, operands, types)
    for a, v in zip(lin, cts):
        if _is_t(a):
            vjp.acc(ctx, env, a[1], v)


_TRANSPOSE = {
    "copy": _tr_copy, "neg": _tr_neg, "add": _tr_add, "sub": _tr_sub,
    "mul": _tr_mul, "div": _tr_div, "add_any": _tr_add_any,
    "convert_element_type": _tr_convert, "reduce_sum": _tr_reduce_sum,
    "broadcast_in_dim": _tr_broadcast_in_dim, "reshape": _tr_reshape,
    "transpose": _tr_transpose, "squeeze": _tr_squeeze, "slice": _tr_slice,
    "pad": _tr_pad,
    "concatenate": _tr_concatenate, "split": _tr_split,
    "cumsum": _tr_cumsum, "dot_general": _tr_dot_general,
    "select_n": _tr_select_n, "gather": _tr_gather,
    "scatter-add": _tr_scatter_add,
    "kernel:flash_attention_bwd": _tr_kernel_bwd,
    "kernel:rg_lru_bwd": _tr_kernel_bwd,
}


def value_and_grad(prog, scans: list[ScanRecord], loss: int,
                   wrt: list[int], stopped: set[int], remat: bool) -> list[int]:
    """Append the backward of ``loss`` to ``prog``; returns the gradient
    values of ``wrt``.

    ``prog`` holds the forward (every op so far computes it); its ops
    are re-emitted in the reference's order — hoisted loop invariants,
    residuals, residual ``ys`` — and the backward follows.

    Args:
        prog: the program being traced.
        scans: the forward's top-level scans, as the tracer recorded
            them (nested ones in their ``children``).
        loss: the 0-d float value to differentiate.
        wrt: the values to differentiate with respect to (the parameter
            inputs), in output order.
        stopped: values whose uses carry no gradient (detached).
        remat: the backward recomputes each scan body (``cfg.remat``).

    Returns:
        One gradient vid per ``wrt`` entry, of its shape and dtype.
    """
    vjp = _VJP(prog, stopped)
    vjp.active = set(wrt)
    ops = vjp.ops = prog.ops
    vjp.find_custom(ops, [loss])
    trips = [prog.trip_counts[i] for i in range(len(ops))]
    by_lo = {s.lo: s for s in scans}
    items: list = []
    i = 0
    while i < len(ops):
        if i in by_lo:
            s = by_lo[i]
            items.append(s)
            i = s.hi
        else:
            items.append(i)
            i += 1
    for it in items:
        if isinstance(it, ScanRecord):
            vjp.scan_activity(it)
        else:
            vjp._op_activity(ops[it])
    if not vjp.is_active(loss):
        raise ValueError("the loss does not depend on the values to "
                         "differentiate")
    prog.ops, prog.trip_counts = [], {}
    top = _Ctx(1)
    tape: list[Lin] = []
    for it in items:
        if isinstance(it, ScanRecord):
            plan = vjp.linearize(it, remat)
            vjp.emit_scan(plan, top, plan.lin is not None)
            tape.append(Lin("scan", {}, [], scan=plan if plan.lin else None))
            continue
        op = ops[it]
        prog.add_op(op, trips[it])
        if not vjp.differentiates(op):
            continue
        vjp.new_rs = []
        tape.extend(vjp.jvp(op))
        for r in vjp.new_rs:
            vjp.mat(top, r)
    # what the linear program computes before any transposition
    for e in tape:
        if e.prim == "scan" and e.scan is not None:
            vjp.tangent_zeros(top, e.scan)
    env = {loss: vjp.lit(prog.types[loss].dtype)}
    vjp.transpose(top, tape, env)
    grads = []
    for w in wrt:
        ct = env.get(w)
        if ct is None:
            t = prog.types[w]
            ct = vjp.zeros(top, t.shape, t.dtype)
        grads.append(ct)
    return grads
