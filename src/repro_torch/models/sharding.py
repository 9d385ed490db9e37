"""Logical-axis sharding bridge and the kernel-dispatch state.

Models annotate activations with *logical dimension names* (``batch``,
``seq``, ``embed``, ``hidden``, ``heads``, ``experts`` …) through
:func:`constrain`.  A rules map ``{logical name -> mesh axes}`` — the
plan's ``logical_rules``, or one written by hand for the expert
baselines (:data:`MANUAL_RULES`) — turns those annotations into
placements: under installed rules :func:`constrain` redistributes a
DTensor to the spec the rules give its dims.  With no rules installed,
or on a plain tensor, every annotation is a no-op, so the same model
code runs unsharded on one device and partitioned over a ``DeviceMesh``.

This is the port's materialisation of the paper's flow: TOAST picks
*which* named dimensions to shard; DTensor's sharding propagation does
the mechanics, as GSPMD does in the reference.  Where DTensor, which
chooses each op's strategy by itself, would execute a plan otherwise
than GSPMD does, the models steer it to GSPMD's choice:
:func:`gather_for` gathers weights before their products, and
:func:`embedding` looks tokens up in a sharded table as GSPMD does.

:class:`KernelDispatch` carries a plan's per-site kernel decisions, and
on a mesh each sharded site's specs, to ``kernels.ops``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
from typing import Any

_STATE = threading.local()

# reshapes of DTensors that DTensor cannot shard, run on the dim made whole
# first: reshape kind -> times (this process; the mesh runs print it)
made_whole: collections.Counter = collections.Counter()
# elementwise ops without a DTensor sharding rule, run on each rank's
# local tensors: op -> times
local_ops: collections.Counter = collections.Counter()
# ops that torch 2.11's DTensor rules cannot place, run on each rank's
# shards (einsums, cache writes) or on an input made whole on the mesh
# dims the rule refuses (products): op -> times
per_shard: collections.Counter = collections.Counter()


def set_rules(rules: dict[str, tuple[str, ...]] | None) -> None:
    """Install ``rules`` for this thread (``None`` or empty: none)."""
    _STATE.rules = dict(rules) if rules else None


def get_rules() -> dict[str, tuple[str, ...]] | None:
    """This thread's rules map, or ``None``."""
    return getattr(_STATE, "rules", None)


@contextlib.contextmanager
def logical_rules(rules: dict[str, tuple[str, ...]] | None):
    """Install ``rules`` for the body of a ``with`` statement."""
    prev = get_rules()
    set_rules(rules)
    try:
        yield
    finally:
        set_rules(prev)


def spec_for(names: tuple[str | None, ...]):
    """The ``PartitionSpec`` the installed rules give ``names``.

    Each dim takes its name's mesh axes, less those an earlier dim took;
    ``None`` when no rules are installed or no dim takes an axis.
    """
    from repro_torch.core.partitioner import PartitionSpec
    rules = get_rules()
    if not rules:
        return None
    entries = []
    used: set[str] = set()
    nontrivial = False
    for n in names:
        axes = rules.get(n) if n else None
        if axes:
            axes = tuple(a for a in axes if a not in used)
        if axes:
            used.update(axes)
            entries.append(axes[0] if len(axes) == 1 else tuple(axes))
            nontrivial = True
        else:
            entries.append(None)
    return PartitionSpec(*entries) if nontrivial else None


def is_dtensor(x) -> bool:
    """True for a DTensor (a tensor placed on a ``DeviceMesh``)."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x, names: tuple[str | None, ...]):
    """Annotate ``x``'s dims with logical names.

    Under installed rules a DTensor is redistributed to ``spec_for(names)``
    on its own mesh.  A plain tensor has no mesh and is returned as it
    is, as is any tensor when no rules are installed.  The reference
    wraps its constraint in a ``try`` that returns ``x`` on any error,
    which there covers the case of no active mesh; the port tells that
    case by the tensor's type, so a rule naming an axis the mesh lacks
    raises here.
    """
    spec = spec_for(names)
    if spec is None or not is_dtensor(x):
        return x
    from repro_torch.launch.mesh import placements_for
    want = placements_for(spec, x.device_mesh, x.ndim)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def gather_for(tree, x):
    """``tree``'s weights placed for products with the activation ``x``,
    as GSPMD places a plan's weights.

    A mesh dim that shards ``x``'s batch (its leading dim) and a weight
    of the same products cannot shard both: GSPMD all-gathers the weight
    over it, layer by layer, and leaves the activations where the plan
    put them (the reference's compiled HLO for TOAST's 1x2 plans: one
    all-gather per weight and layer, no collective of an activation;
    ``tests/test_torch_mesh_comm.py``).  DTensor, which picks each
    product's strategy by itself, moves the activation onto the weight's
    dim instead and leaves a pending sum, reduced over whole
    activations.  So every DTensor leaf is made whole on those mesh dims
    here, its other placements kept; plain tensors, and any tree when
    ``x`` is not batch-sharded, pass as they are.
    """
    if not is_dtensor(x):
        return tree
    # the mesh dims that shard x's leading dim
    batch = [i for i, p in enumerate(x.placements)
             if p.is_shard() and p.dim % x.ndim == 0]
    if not batch:
        return tree
    from torch.distributed.tensor import Replicate

    from repro_torch import pytree

    def gather(w):
        if not is_dtensor(w) or \
                all(w.placements[i].is_replicate() for i in batch):
            return w
        return w.redistribute(w.device_mesh, [
            Replicate() if i in batch else p
            for i, p in enumerate(w.placements)])
    return pytree.tree_map(gather, tree)


def placed_like(t, ref):
    """``t`` placed as ``ref`` is: a gradient as its parameter.

    DTensor's backward leaves a weight's gradient where the products put
    it, often as a pending sum over the mesh dims that split the
    activations; every optimizer op on it would then reduce it whole
    again.  GSPMD reduces each gradient once, onto its parameter's
    sharding (a reduce-scatter for a sharded weight); so does this.
    Plain tensors pass as they are, so traced programs do not change.
    """
    if not is_dtensor(t) or not is_dtensor(ref) or \
            tuple(t.placements) == tuple(ref.placements):
        return t
    return t.redistribute(ref.device_mesh, ref.placements)


def embedding(tokens, table):
    """``F.embedding(tokens, table)``, on DTensors as GSPMD runs it.

    The table stays as it lies: the token ids are made whole on the mesh
    dims that shard the table (an all-gather of the ids), the lookup runs
    on the table's shards, and its result is placed on those mesh dims
    as the tokens were (an all-to-all from the table's feature dim, a
    reduce-scatter from its vocabulary dim), as the reference's compiled
    HLO does.  Gathering the table instead would move it whole every
    call.
    """
    import torch.nn.functional as F
    if not is_dtensor(table):
        return F.embedding(tokens, table)
    from torch.distributed.tensor import Replicate
    mesh = table.device_mesh
    on = [i for i, p in enumerate(table.placements) if not p.is_replicate()]
    ids = tokens.redistribute(mesh, [
        Replicate() if i in on else p
        for i, p in enumerate(tokens.placements)])
    h = F.embedding(ids, table)
    return h.redistribute(mesh, [
        tokens.placements[i] if i in on else p
        for i, p in enumerate(h.placements)])


def replicate_like(t, ref):
    """``t`` placed beside ``ref``: a plain tensor made on each rank alike
    (an iota, a mask) becomes a replicated DTensor on ``ref``'s mesh
    when ``ref`` is a DTensor; otherwise ``t`` itself.

    DTensor refuses an op that mixes the two kinds, and a value every
    rank computes whole is replicated by construction, so nothing moves.
    """
    if not is_dtensor(ref) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def split_dim(t, dim: int, sizes: tuple[int, ...]):
    """``t`` with dim ``dim`` split into ``sizes`` (one reshape).

    On a DTensor whose ``dim`` is sharded ``F`` ways, DTensor cannot
    split it when the leading size is above 1 and ``F`` does not divide
    it: on one mesh dim it refuses ("cannot unflatten unevenly sharded"),
    on two it computes a wrong local shape.  Such a dim is made whole
    first, explicitly, and counted in :data:`made_whole`.  A plain tensor
    is reshaped as it is, so traced programs do not change.
    """
    dim %= t.ndim
    if is_dtensor(t) and sizes[0] > 1:
        mesh = t.device_mesh
        on = [i for i, p in enumerate(t.placements)
              if p.is_shard() and p.dim == dim]
        ways = 1
        for i in on:
            ways *= mesh.size(i)
        if sizes[0] % ways:
            from torch.distributed.tensor import Replicate
            made_whole[f"split of a dim sharded {ways} ways into "
                       f"{tuple(sizes)}"] += 1
            placements = [Replicate() if i in on else p
                          for i, p in enumerate(t.placements)]
            t = t.redistribute(mesh, placements)
    return t.reshape(*t.shape[:dim], *sizes, *t.shape[dim + 1:])


def pointwise(fn, *args):
    """``fn(*args)`` for an elementwise ``fn`` of same-shaped tensors.

    On DTensors that DTensor has no sharding rule for ``fn``'s op (in
    torch 2.11 ``aten.ne.Tensor``, which ``softplus``'s NaN test issues),
    ``fn`` runs on each rank's local tensors under ``local_map``, every
    input placed as the first DTensor is (a pending sum made whole
    first): the placement DTensor's own elementwise rule gives.  Counted
    in :data:`local_ops`.  Plain tensors take ``fn`` itself, so traced
    programs do not change.
    """
    ref = next((a for a in args if is_dtensor(a)), None)
    if ref is None:
        return fn(*args)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    local_ops[fn.__name__] += 1
    placements = tuple(Replicate() if p.is_partial() else p
                       for p in ref.placements)
    return local_map(fn, out_placements=(placements,),
                     in_placements=tuple(placements if is_dtensor(a) else None
                                         for a in args),
                     device_mesh=ref.device_mesh,
                     redistribute_inputs=True)(*args)


def matmul(x, w):
    """``x @ w`` of a (B, S, D) activation and a (D, F) weight.

    DTensor in torch 2.11 lowers ``x @ w`` to a matrix product over a
    view that flattens (B, S), and refuses the view when S is sharded
    (the sequence under ``MANUAL_RULES``), in the forward or, for the
    gradient arriving at the product, in the backward.  On DTensors the
    product is therefore a batched one, ``x`` against ``w`` broadcast
    over the batch, which flattens nothing; counted in
    :data:`per_shard`.  Plain tensors take ``@`` itself, so traced
    programs do not change.
    """
    if not is_dtensor(x) or x.ndim != 3:
        return x @ w
    import torch
    per_shard["matmul"] += 1
    return torch.bmm(x, w.expand(x.shape[0], *w.shape))


def einsum(equation: str, *operands):
    """``torch.einsum(equation, *operands)``, on DTensors per shard.

    DTensor in torch 2.11 lowers an einsum through reshapes that flatten
    its batch dims, and refuses to flatten one whose inner dim is
    sharded (the attention's ``bkgst,btkh->bskgh`` with its kv heads
    sharded, in decode).  On DTensors the einsum therefore runs on each
    rank's local tensors under ``local_map``: on each mesh dim, a letter
    that the first sharded operand shards there stays sharded when every
    operand and the output have it (a batch letter: each rank's block is
    computed alone, and so are its gradients) and the mesh dim divides
    it; any other shard or pending sum is made whole.  Counted in
    :data:`per_shard`.  Plain tensors take ``torch.einsum`` itself, so
    traced programs do not change.
    """
    import torch
    ref = next((x for x in operands if is_dtensor(x)), None)
    if ref is None:
        return torch.einsum(equation, *operands)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from torch.distributed.tensor.placement_types import _StridedShard
    ins, out = equation.replace(" ", "").split("->")
    ins = ins.split(",")
    mesh = ref.device_mesh
    in_pl = [[Replicate()] * mesh.ndim for _ in operands]
    out_pl = [Replicate()] * mesh.ndim
    for i in range(mesh.ndim):
        letter = None
        for x, spec in zip(operands, ins):
            p = x.placements[i] if is_dtensor(x) else Replicate()
            if p.is_shard() and not isinstance(p, _StridedShard):
                letter = spec[p.dim % len(spec)]
                break
        if letter is None or letter not in out or any(
                letter not in spec or x.shape[spec.index(letter)] %
                mesh.size(i) for x, spec in zip(operands, ins)):
            continue
        for pl, spec in zip(in_pl, ins):
            pl[i] = Shard(spec.index(letter))
        out_pl[i] = Shard(out.index(letter))
    per_shard["einsum"] += 1
    operands = [replicate_like(x, ref) for x in operands]
    return local_map(lambda *xs: torch.einsum(equation, *xs),
                     out_placements=(tuple(out_pl),),
                     in_placements=tuple(tuple(p) for p in in_pl),
                     device_mesh=mesh, redistribute_inputs=True)(*operands)


def index_copy(t, dim: int, index, src):
    """``t.index_copy(dim, index, src)``: a decode step's cache write.

    DTensor in torch 2.11 has no sharding rule for ``aten.index_copy``
    (its decomposition's ``index_put`` rule fails), so on DTensors the
    copy runs on each rank's local tensors under ``local_map``: ``t``
    and ``src`` placed as ``t`` is, less any shard of ``dim`` (made
    whole) or pending sum, and the index replicated.  Counted in
    :data:`per_shard`.  Plain tensors take ``index_copy`` itself, so
    traced programs do not change.
    """
    ref = t if is_dtensor(t) else src if is_dtensor(src) else None
    if ref is None:
        return t.index_copy(dim, index, src)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = ref.device_mesh
    dim %= t.ndim
    per_shard["index_copy"] += 1
    placements = tuple(
        Replicate() if p.is_partial() or (p.is_shard() and p.dim == dim)
        else p for p in ref.placements)
    whole = (Replicate(),) * mesh.ndim
    t, index, src = (replicate_like(x, ref) for x in (t, index, src))
    return local_map(lambda a, i, b: a.index_copy(dim, i, b),
                     out_placements=(placements,),
                     in_placements=(placements, whole, placements),
                     device_mesh=mesh, redistribute_inputs=True)(
                         t, index, src)


# ---------------------------------------------------------------------------
# kernel dispatch: per-site impl registry for the fused kernels
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KernelDispatch:
    """Ambient per-run kernel-dispatch state (``kernels.ops`` reads it).

    Sites are keyed ``"<kernel>:<ordinal>"`` in call-occurrence order
    per kernel kind — the same order the fused ops appear in the traced
    IR.  The traced layer scan holds one instance of its body, so every
    iteration of the eager layer loop runs under the body's site keys
    (``transformer.scan_layers`` rewinds the counters with
    :meth:`mark` / :meth:`rewind`).  ``plan.apply`` installs one of these
    carrying the searched plan's per-site impl decisions and, on a mesh
    of two or more devices, the mesh and each sharded site's specs,
    which ``kernels.ops`` turns into the placements of the site's
    ``local_map``.

    Attributes:
        impls: site key -> impl name ("cuda" | "ref").
        default_impl: impl for sites without an explicit entry
            (``None`` = the registry's default).
        mesh: the ``DeviceMesh`` the sites' DTensors lie on.
        specs: sharded site key -> ``(in_specs tuple, out_specs)``
            ``PartitionSpec``s (mappable roles only).
    """

    impls: dict = dataclasses.field(default_factory=dict)
    default_impl: str | None = None
    mesh: Any = None
    specs: dict = dataclasses.field(default_factory=dict)
    _counters: dict = dataclasses.field(default_factory=dict)

    def next_site(self, kernel: str) -> str:
        """Allocate the next site key for one ``kernel`` call."""
        n = self._counters.get(kernel, 0)
        self._counters[kernel] = n + 1
        return f"{kernel}:{n}"

    def reset(self) -> None:
        """Reset the per-run ordinal counters."""
        self._counters.clear()

    def mark(self) -> dict:
        """A snapshot of the ordinal counters (see :meth:`rewind`)."""
        return dict(self._counters)

    def rewind(self, mark: dict) -> None:
        """Return the ordinal counters to a :meth:`mark` snapshot."""
        self._counters = dict(mark)

    def impl_for(self, site: str) -> str | None:
        """The impl decision for ``site`` (falls back to the default)."""
        return self.impls.get(site, self.default_impl)

    def specs_for(self, site: str):
        """``(mesh, in_specs, out_specs)`` for a sharded site, or None."""
        spec = self.specs.get(site)
        if spec is None or self.mesh is None:
            return None
        return (self.mesh, *spec)


def get_kernel_dispatch() -> KernelDispatch | None:
    """The thread's active :class:`KernelDispatch`, or ``None``."""
    return getattr(_STATE, "kernel_dispatch", None)


@contextlib.contextmanager
def kernel_dispatch(disp: KernelDispatch | None, *, reset: bool = True):
    """Install ``disp`` as the ambient dispatch for this thread.

    Entering resets the site ordinal counters, so one context spans
    exactly one run of the model function.  With ``reset=False`` the
    counters are kept: autograd's backward, which runs on a thread of
    its own for CUDA tensors, re-enters a forward's dispatch that way to
    recompute a checkpointed layer body.
    """
    prev = get_kernel_dispatch()
    if disp is not None and reset:
        disp.reset()
    _STATE.kernel_dispatch = disp
    try:
        yield disp
    finally:
        _STATE.kernel_dispatch = prev


# Expert/manual baseline rules (paper §5.1.1): FSDP + Megatron + sequence
# parallelism for transformer LMs.
MANUAL_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("data",),
    "act_batch": ("data",),   # activation batch (cache batch is "batch")
    "seq": ("model",),       # sequence parallelism for activations
    "hidden": ("model",),    # Megatron MLP sharding
    "heads": ("model",),     # Megatron attention-head sharding
    "experts": ("model",),   # expert parallelism
    "vocab": ("model",),
    "embed_fsdp": ("data",),  # FSDP parameter sharding axis
}

MANUAL_RULES_MULTIPOD: dict[str, tuple[str, ...]] = {
    **MANUAL_RULES,
    "batch": ("pod", "data"),
    "act_batch": ("pod", "data"),
}

# Weight-stationary decode (Pope et al. "Efficiently scaling transformer
# inference"): keep 2D-sharded weights resident, reshard the tiny per-token
# activations instead — activations drop the batch axis so their embed dim
# can take "data" and contract against data-sharded weights locally.
DECODE_WEIGHT_STATIONARY_RULES: dict[str, tuple[str, ...]] = {
    **MANUAL_RULES,
    "act_batch": (),
    "embed": ("data",),
}
