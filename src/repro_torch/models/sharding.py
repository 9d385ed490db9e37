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
        return w.redistribute(w.device_mesh, _partnered(w.device_mesh, [
            Replicate() if i in batch else p
            for i, p in enumerate(w.placements)]))
    return pytree.tree_map(gather, tree)


def _partnered(mesh, placements) -> list:
    """``placements`` with every strided shard that lacks its partner
    made whole (:func:`_lone_strided`): a layout torch's DTensor can
    redistribute to.  Other placements are kept."""
    from torch.distributed.tensor import Replicate
    out = list(placements)
    for i in range(len(out)):
        if _lone_strided(mesh, out, i):
            out[i] = Replicate()
    return out


def _lone_strided(mesh, placements, i: int) -> bool:
    """Whether ``placements[i]`` is a strided shard without its partner,
    the plain shard of its dim on a later mesh dim of its split factor
    (no block layout: torch 2.11 refuses it)."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    p = placements[i]
    return isinstance(p, _StridedShard) and not any(
        type(q) is Shard and q.dim == p.dim and
        mesh.size(j) == p.split_factor
        for j, q in enumerate(placements) if j > i)


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


def cat_like(tensors, dim: int, ref):
    """``torch.cat(tensors, dim)`` placed as ``ref`` (one of them) is.

    DTensor concatenates along a sharded dim by making it whole on every
    input, and leaves the result whole: a vision model's patch
    embeddings placed before its sequence-sharded tokens would then run
    every layer on the whole residual stream.  The result takes
    ``ref``'s placements back (a slice of the whole, no collective) when
    each mesh dim that shards ``dim`` divides its size, as GSPMD keeps
    the plan's sharding of the concatenated dim.  Plain tensors take
    ``torch.cat`` itself, so traced programs do not change.
    """
    import torch
    out = torch.cat(tensors, dim=dim)
    if not is_dtensor(out) or not is_dtensor(ref):
        return out
    dim %= out.ndim
    mesh = ref.device_mesh
    ways = 1
    for i, p in enumerate(ref.placements):
        if p.is_shard() and p.dim == dim:
            ways *= mesh.size(i)
    if ways == 1 or out.shape[dim] % ways:
        return out
    return placed_like(out, ref)


def reduced_onto(t, ref):
    """``t`` with each pending sum reduced once onto ``ref``'s placement
    on that mesh dim: a reduce-scatter onto a shard, an all-reduce onto
    a replica.  A mesh dim where ``ref`` is itself a pending sum keeps
    ``t``'s (the two add as they are), as do ``t``'s other placements.
    Plain tensors pass as they are.
    """
    if not is_dtensor(t) or not is_dtensor(ref):
        return t
    return _reduced_to(t, ref.placements)


def _reduced_to(t, placements):
    """``t`` with each pending sum reduced onto ``placements`` on that
    mesh dim, unless that is a pending sum too (:func:`reduced_onto`)."""
    want = tuple(r if p.is_partial() and not r.is_partial() else p
                 for p, r in zip(t.placements, placements))
    if want == tuple(t.placements):
        return t
    return t.redistribute(t.device_mesh, want)


def reduced_for_einsum(t, equation: str, *operands):
    """``t`` with each pending sum reduced onto the placement that
    :func:`einsum` gives ``einsum(equation, *operands)``'s result (a
    reduce-scatter onto its shard, an all-reduce onto a replica), so
    that the two meet without making ``t`` whole first; the einsum is
    not run.  Plain tensors pass as they are."""
    ref = next((x for x in operands if is_dtensor(x)), None)
    if not is_dtensor(t) or ref is None:
        return t
    ins, out = equation.replace(" ", "").split("->")
    _, (out_pl,) = _local_placements(ref.device_mesh, operands,
                                     ins.split(","), [out])
    return _reduced_to(t, out_pl)


def reduced(t):
    """``t`` with every pending sum reduced to a replica; plain tensors
    pass as they are.

    The loss head reduces its logits where a product over a sharded
    d_model left them a pending sum, and its gold logit: a gather along
    a sharded vocabulary leaves a masked pending sum whose mask has the
    gather's shape, which torch's DTensor applies wrongly once a view
    has dropped a dim (``squeeze``).
    """
    if not is_dtensor(t) or not any(p.is_partial() for p in t.placements):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [
        Replicate() if p.is_partial() else p for p in t.placements])


def embedding(tokens, table):
    """``F.embedding(tokens, table)``, on DTensors as GSPMD runs it.

    The table stays as it lies: the token ids are made whole on the mesh
    dims that shard the table (an all-gather of the ids), the lookup runs
    on the table's shards, and its result is placed on those mesh dims
    as the tokens were (an all-to-all from the table's feature dim, a
    reduce-scatter from its vocabulary dim), as the reference's compiled
    HLO does; but a mesh dim that shards both the tokens' sequence and
    the table's features keeps the features sharded, as GSPMD does for
    TOAST's MoE train plans of that shape.  Gathering the table instead
    would move it whole every call.
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
    # a mesh dim that shards the tokens' sequence and the table's
    # features keeps the features sharded: the residual stream then runs
    # whole in the sequence, and each product with a row-sharded weight
    # leaves a pending sum reduced once (moving the sequence back would
    # cost an all-to-all here and at every product)
    want = [p if p.is_shard() and p.dim == 2 and
            tokens.placements[i].is_shard() and tokens.placements[i].dim == 1
            else tokens.placements[i] if i in on else p
            for i, p in enumerate(h.placements)]
    # a vocabulary-sharded table leaves a masked pending sum, its mask of
    # the ids' shape: it is reduced first, while h keeps that shape
    # (torch's DTensor applies it to a reshaped block otherwise), and
    # its gradient must arrive as no pending sum, which DTensor cannot
    # turn back into a masked one
    first = [w if p.is_partial() else p for p, w in zip(h.placements, want)]
    if first != list(h.placements):
        h = h.redistribute(mesh, first)
    return grad_settled(h.redistribute(mesh, want))


def grad_settled(t):
    """``t`` itself, its gradient placed as ``t`` is (pending sums made
    replicas) before it flows on into ``t``'s producer.

    The producer's backward then starts from a reduced gradient: a
    ``local_map`` output that is a pending sum takes a replica as its
    gradient (each rank's block backward needs the whole of it), and a
    masked pending sum (a lookup in a vocabulary-sharded table) takes no
    pending sum, which torch's DTensor cannot turn back into a masked
    one.  Plain tensors, and tensors that take no gradient, pass as they
    are.
    """
    if not is_dtensor(t) or not t.requires_grad:
        return t
    from torch.distributed.tensor import Replicate
    want = tuple(Replicate() if p.is_partial() else p for p in t.placements)

    def settle(g):
        if tuple(g.placements) == want:
            return g
        return g.redistribute(g.device_mesh, want)
    t.register_hook(settle)
    return t


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


def whole_along(t, dim: int, why: str):
    """``t`` with dim ``dim`` made whole on every mesh dim that shards it,
    its other placements kept; counted in :data:`made_whole` under
    ``why``.  For a block that mixes every position of ``dim`` (the
    mLSTM's quadratic form over the sequence): GSPMD runs it on the
    whole dim, and DTensor, left to itself, moves each of the block's
    products between shards.  A plain tensor passes as it is, so traced
    programs do not change.
    """
    if not is_dtensor(t):
        return t
    dim %= t.ndim
    on = [i for i, p in enumerate(t.placements)
          if p.is_shard() and p.dim == dim]
    if not on:
        return t
    from torch.distributed.tensor import Replicate
    made_whole[why] += 1
    return t.redistribute(t.device_mesh, [
        Replicate() if i in on else p for i, p in enumerate(t.placements)])


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


def layer(t, i: int):
    """``t[i]``: layer ``i`` of a stacked leaf.

    torch 2.11's DTensor takes the index of a leaf with a strided shard
    (``launch.mesh.placements_for``'s for two axes against the mesh's
    order, as TOAST's expert plans give them) to a layout it cannot
    redistribute: the plain shard moves down a dim and the strided one
    stays.  Such a leaf, whose leading dim no mesh dim shards, is
    indexed on each rank's block instead, every shard moved down a dim.
    A leaf whose layer dim one mesh dim shards takes the layer from the
    rank that holds it (:func:`_owned_layer`).  Any other tensor takes
    ``t[i]`` itself.
    """
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    if not is_dtensor(t):
        return t[i]
    lead = [j for j, p in enumerate(t.placements)
            if (p.is_shard() or isinstance(p, _StridedShard)) and p.dim == 0]
    if len(lead) == 1 and type(t.placements[lead[0]]) is Shard and \
            t.shape[0] % t.device_mesh.size(lead[0]) == 0:
        return _owned_layer(t, i, lead[0])
    if lead or not any(isinstance(p, _StridedShard) for p in t.placements):
        return t[i]
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(
        t.to_local()[i], t.device_mesh,
        [_shard_on(p, p.dim - 1) if p.is_shard() or
         isinstance(p, _StridedShard) else p for p in t.placements],
        run_check=False, shape=t.shape[1:], stride=t.stride()[1:])


def _owned_layer(t, i: int, j: int):
    """Layer ``i`` of a stacked leaf whose layer dim mesh dim ``j`` shards
    (alone): the rank that holds the layer hands it to the others, a
    pending sum of its block and the others' zeros reduced on ``j``, as
    GSPMD slices a layer-sharded stack inside its layer loop.  Indexing
    the DTensor instead gathers the whole stack for every layer, and its
    gradient too.  The other placements move down a dim."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = t.device_mesh
    local = t.to_local()
    owner, k = divmod(i, local.shape[0])
    # the others' zeros stay in the graph (zero gradient), so every rank
    # runs the same backward
    piece = local[k] if mesh.get_coordinate()[j] == owner else local[k] * 0
    pl = [_shard_on(p, p.dim - 1) if p.is_shard() else p
          for p in t.placements]
    out = DTensor.from_local(
        piece, mesh, [Partial() if m == j else p for m, p in enumerate(pl)],
        run_check=False, shape=t.shape[1:], stride=t.stride()[1:])
    return out.redistribute(mesh, [Replicate() if m == j else p
                                   for m, p in enumerate(pl)])


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
    :data:`per_shard`.  A weight sharded only on mesh dims where ``x``
    is replicated, a pending sum or sharded on its features, or where
    ``x``'s sequence is sharded and the weight's rows, stays where it
    lies instead, as GSPMD keeps a decode plan's 2-D sharded weights and
    a train plan's row-sharded ones: ``x`` is moved to it (an all-to-all
    from its sequence onto its features) and the product runs per shard
    (:func:`_local_placements`).  Plain tensors take ``@`` itself, so
    traced programs do not change.
    """
    if not is_dtensor(x) or x.ndim != 3:
        return x @ w
    import torch
    if _stationary(x, w):
        # the weight stays where it lies (a decode plan's 2-D sharded
        # weights; a train plan's weights sharded on their rows against
        # a sharded sequence) and x moves to it: a shard of its rows
        # leaves a pending sum
        in_pl, out_pl = _local_placements(x.device_mesh, [w, x],
                                          ["df", "bsd"], ["bsf"],
                                          movable=(1,))
        per_shard["matmul stationary"] += 1
        out = _run_local(lambda w_, x_: x_ @ w_, x.device_mesh, [w, x],
                         in_pl, out_pl)
        # a pending sum where x's sequence was sharded is reduced back
        # onto it (a reduce-scatter), as GSPMD returns the product
        back = [x.placements[i] if p.is_partial() and
                x.placements[i].is_shard() and x.placements[i].dim % 3 == 1
                else p for i, p in enumerate(out.placements)]
        if back != list(out.placements):
            out = out.redistribute(out.device_mesh, back)
        return out
    per_shard["matmul"] += 1
    return torch.bmm(x, w.expand(x.shape[0], *w.shape))


def _stationary(x, w) -> bool:
    """Whether :func:`matmul` keeps ``w`` where it lies and moves ``x``
    to it: ``w`` is sharded only on mesh dims where ``x`` is not
    sharded, is sharded on its features, or is sharded on its sequence
    against ``w``'s rows."""
    if not is_dtensor(w):
        return False
    sharded = [i for i, p in enumerate(w.placements) if not p.is_replicate()]

    def stays(i):
        p, q = x.placements[i], w.placements[i]
        return not p.is_shard() or p.dim % 3 == 2 or (
            p.dim % 3 == 1 and q.is_shard() and q.dim == 0)
    return bool(sharded) and all(stays(i) for i in sharded)


def matmul_input(x, w):
    """``x`` placed as :func:`matmul` places it for ``x @ w`` when ``w``
    stays where it lies, else ``x`` itself.

    An activation that several products take (the mLSTM's normed input,
    taken by its five projections) is then moved once, and its
    gradients, summed where they arrive, move back once; each product
    moving it again would move it, and its gradient, once a product.
    Plain tensors pass as they are, so traced programs do not change.
    """
    if not is_dtensor(x) or x.ndim != 3 or not _stationary(x, w):
        return x
    (_, pl), _ = _local_placements(x.device_mesh, [w, x], ["df", "bsd"],
                                   ["bsf"], movable=(1,))
    return x if tuple(x.placements) == pl else \
        x.redistribute(x.device_mesh, pl)


_LETTERS = "abcdefghijklm"


def _shard_on(p, dim: int):
    """The shard ``p`` (plain or strided) moved to tensor dim ``dim``."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    if isinstance(p, _StridedShard):
        return _StridedShard(dim, split_factor=p.split_factor)
    return Shard(dim)


def _local_placements(mesh, operands, specs, outs, whole: str = "",
                      linear: int | None = None, movable=()):
    """The placements under which an op of lettered operands runs on each
    rank's blocks (:func:`einsum` and the MoE ops).

    ``specs`` and ``outs`` give each operand's and output's dims a
    letter; ``"."`` marks a dim of size one that broadcasts.  On each
    mesh dim, the letters the operands shard there are tried in operand
    order, and the first that fits is kept.  A letter fits when the mesh
    dim divides it, it is not in ``whole``, and either every operand
    with it is sharded on it alike there, replicated or a pending sum
    (reduced onto the shard) while every operand without it is
    replicated or a pending sum there (reduced whole; an operand of
    ``movable`` may lie anyhow: it is moved), or every operand and
    output has it (a batch letter).  The operands with the kept letter
    are sharded on it (a slice of a replicated one, no collective;
    another is moved), the
    rest replicated; an output with it is sharded on it, one without it
    (the letter was contracted away) is a pending sum (``Partial``).  A
    strided shard (``launch.mesh.placements_for``'s for two axes against
    the mesh's order) is kept only in the first way, and only beside the
    plain shard of its letter on its partner mesh dim (torch 2.11
    refuses a lone one).  Where no letter fits, the operand ``linear``
    (the op is linear in it) keeps a pending sum when every other
    operand is replicated there, and so do the outputs.  Anything else
    is made whole, pending sums included.

    Returns:
        ``(in placements, out placements)``: a tuple per operand and per
        output.
    """
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    in_pl = [[Replicate()] * mesh.ndim for _ in operands]
    out_pl = [[Replicate()] * mesh.ndim for _ in outs]

    def fits(i, x, p, letter, placed):
        if _lone_strided(mesh, x.placements, i):
            # not the layout placements_for gives (a reshape's)
            return None
        ways = mesh.size(i) * getattr(p, "split_factor", 1)
        if letter == "." or letter in whole or any(
                letter in s and x.shape[s.index(letter)] % ways
                for x, s in zip(operands, specs)):
            return None
        want = [_shard_on(p, s.index(letter)) if letter in s else None
                for s in specs]
        # a pending sum is reduced onto the letter's shard if it has the
        # letter (a reduce-scatter), else onto a replica (an all-reduce),
        # as GSPMD feeds a contracted product's result to the next
        # product whose weight stays sharded
        ok = all(q.is_replicate() or j in movable or (
            q.is_partial() if w is None else
            type(q) is type(w) and q == w or
            q.is_partial() and type(w) is Shard)
            for j, (q, w) in enumerate(zip(placed, want)))
        if not isinstance(p, _StridedShard):
            ok = ok or all(letter in s for s in (*specs, *outs))
        return want if ok else None

    # mesh dim -> (the letter kept there, a strided shard's partner dim)
    kept: dict[int, tuple[str, int | None]] = {}
    for i in range(mesh.ndim):
        placed = [x.placements[i] if is_dtensor(x) else Replicate()
                  for x in operands]
        cands = []
        for x, p, spec in zip(operands, placed, specs):
            if p.is_shard() or isinstance(p, _StridedShard):
                cands.append((x, p, spec[p.dim % len(spec)]))
        # the partner of a strided shard kept earlier tries its letter
        first = [k for k, part in kept.values() if part == i]
        cands.sort(key=lambda c: c[2] not in first)
        for x, p, letter in cands:
            want = fits(i, x, p, letter, placed)
            if want is None:
                continue
            for pl, w in zip(in_pl, want):
                if w is not None:
                    pl[i] = w
            for pl, s in zip(out_pl, outs):
                pl[i] = _shard_on(p, s.index(letter)) if letter in s \
                    else Partial()
            kept[i] = (letter, next(
                (j for j in range(i + 1, mesh.ndim)
                 if mesh.size(j) == p.split_factor), None)
                if isinstance(p, _StridedShard) else None)
            break
        else:
            if linear is not None and placed[linear].is_partial() and all(
                    q.is_replicate() for j, q in enumerate(placed)
                    if j != linear):
                in_pl[linear][i] = placed[linear]
                for pl in out_pl:
                    pl[i] = placed[linear]
    # a strided shard means nothing without the plain shard of its letter
    # on its partner mesh dim: where that was not kept, made whole
    for i, (letter, part) in kept.items():
        if part is not None and kept.get(part, (None,))[0] != letter:
            for pl in (*in_pl, *out_pl):
                pl[i] = Replicate()
    return [tuple(p) for p in in_pl], [tuple(p) for p in out_pl]


def _run_local(fn, mesh, operands, in_pl, out_pl):
    """``fn`` on each rank's blocks of ``operands`` under ``local_map``,
    the operands redistributed to ``in_pl`` (plain tensors made
    replicated DTensors first) and the outputs placed as ``out_pl``.

    An operand replicated on a mesh dim where an output is sharded or a
    pending sum takes a pending sum as its gradient there (each rank's
    block contributes its part); a pending-sum operand takes a replica.
    An output that is a pending sum takes its gradient made whole first
    (:func:`grad_settled`): each rank's block backward needs all of it.
    """
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    ref = next(x for x in operands if is_dtensor(x))
    operands = [replicate_like(x, ref) for x in operands]
    split = [any(not pl[i].is_replicate() for pl in out_pl)
             for i in range(mesh.ndim)]
    grads = tuple(tuple(Partial() if p.is_replicate() and split[i] else
                        Replicate() if p.is_partial() else p
                        for i, p in enumerate(pl)) for pl in in_pl)
    out = local_map(fn, out_placements=tuple(out_pl),
                    in_placements=tuple(in_pl), in_grad_placements=grads,
                    device_mesh=mesh, redistribute_inputs=True)(*operands)
    if isinstance(out, tuple):
        return tuple(grad_settled(o) for o in out)
    return grad_settled(out)


def einsum_inputs(equation: str, *operands) -> list:
    """``operands`` placed as :func:`einsum` places them for
    ``equation``: an operand that several einsums take is moved once
    (the MoE block's dispatched tokens, taken by the gate's and the
    input's products).  Plain tensors pass as they are.
    """
    ref = next((x for x in operands if is_dtensor(x)), None)
    if ref is None:
        return list(operands)
    ins, out = equation.replace(" ", "").split("->")
    in_pl, _ = _local_placements(ref.device_mesh, operands,
                                 ins.split(","), [out])
    return [moved(x, pl) if is_dtensor(x) else x
            for x, pl in zip(operands, in_pl)]


def moved(x, placements):
    """``x.redistribute(x.device_mesh, placements)``.

    A shard moved from one dim to another on every mesh dim alike (the
    MoE block's dispatched tokens, from their features onto the experts)
    runs as one all-to-all over the mesh flattened, as GSPMD moves it
    over the device group; torch's DTensor would run an all-gather and
    an all-to-all, one mesh dim after the other.  Any other move, and a
    mesh with no flattened form (``launch.mesh.flat_mesh``), takes
    ``redistribute`` itself.
    """
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.launch.mesh import flat_mesh
    mesh, src, dst = x.device_mesh, tuple(x.placements), tuple(placements)
    if src == dst:
        return x
    flat = flat_mesh(mesh)
    a, b = src[0], dst[0]
    if flat is None or any(type(p) is not Shard for p in src + dst) or \
            any(p != a for p in src) or any(p != b for p in dst) or \
            a.dim == b.dim or x.shape[a.dim] % flat.size() or \
            x.shape[b.dim] % flat.size():
        return x.redistribute(mesh, dst)
    y = DTensor.from_local(x.to_local(), flat, [a], run_check=False,
                           shape=x.shape, stride=x.stride())
    y = y.redistribute(flat, [b]).to_local()
    return DTensor.from_local(y, mesh, dst, run_check=False, shape=x.shape,
                              stride=x.stride())


def einsum(equation: str, *operands):
    """``torch.einsum(equation, *operands)``, on DTensors per shard.

    DTensor in torch 2.11 lowers an einsum through reshapes that flatten
    its batch dims, and refuses to flatten one whose inner dim is
    sharded (the attention's ``bkgst,btkh->bskgh`` with its kv heads
    sharded, in decode).  On DTensors the einsum therefore runs on each
    rank's local tensors under ``local_map``, each mesh dim keeping the
    letter :func:`_local_placements` keeps: a batch letter every operand
    has, or a letter the operands that have it share a shard of while
    the others are replicated, as GSPMD keeps a plan's expert weights
    where they lie.  A letter contracted away leaves the result a
    pending sum.  Counted in :data:`per_shard`.  Plain tensors take
    ``torch.einsum`` itself, so traced programs do not change.
    """
    import torch
    ref = next((x for x in operands if is_dtensor(x)), None)
    if ref is None:
        return torch.einsum(equation, *operands)
    ins, out = equation.replace(" ", "").split("->")
    in_pl, out_pl = _local_placements(ref.device_mesh, operands,
                                      ins.split(","), [out])
    per_shard["einsum"] += 1
    return _run_local(lambda *xs: torch.einsum(equation, *xs),
                      ref.device_mesh, operands, in_pl, out_pl)


def scan_per_shard(fn, operands, specs, out: str, whole: str,
                   movable=()):
    """``fn(*operands)`` for a recurrence scanned over one dim of its
    operands (the sLSTM's time loop), on DTensors per shard.

    Run step by step on DTensors, each step's ops would be dispatched
    through DTensor (tens per step, thousands per layer) and any step
    whose placements disagree would move data.  Here the whole loop runs
    once, on each rank's blocks under one ``local_map``: each mesh dim
    keeps the letter :func:`_local_placements` keeps (a letter every
    operand shares a shard of, the others replicated; an operand of
    ``movable`` is moved to it), and the letters of ``whole`` (the
    scanned dim, a dim the step contracts or splits) are made whole
    once, before the loop, each counted in :data:`made_whole`.  Every
    rank then issues the same DTensor ops and collectives, whatever the
    length of the scanned dim.  Gradients flow as through
    :func:`_run_local`.  Plain tensors take ``fn`` itself, so traced
    programs do not change.

    Args:
        fn: the loop on plain tensors, one output.
        operands: its tensors.
        specs: a letter per dim of each operand.
        out: the output's letters.
        whole: letters never sharded in the loop.
        movable: indices of operands that may be moved to the kept
            letter (the weights, as :func:`gather_for` moves them).
    """
    ref = next((x for x in operands if is_dtensor(x)), None)
    if ref is None:
        return fn(*operands)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.placement_types import _StridedShard
    mesh = ref.device_mesh
    in_pl, out_pl = _local_placements(mesh, operands, specs, [out],
                                      whole=whole, movable=movable)
    for x, spec, pl in zip(operands, specs, in_pl):
        if not is_dtensor(x):
            continue
        for p, q in zip(x.placements, pl):
            if (p.is_shard() or isinstance(p, _StridedShard)) and \
                    isinstance(q, Replicate):
                made_whole[f"scan operand dim {spec[p.dim % len(spec)]!r} "
                           f"of {spec}"] += 1
    per_shard["scan"] += 1
    return _run_local(fn, mesh, operands, in_pl, out_pl)


def cumsum(x, dim: int):
    """``torch.cumsum(x, dim)``, on a DTensor per shard.

    torch 2.11's DTensor has no sharding strategy for ``aten.flip``,
    which ``cumsum``'s backward issues (the mLSTM's log-forget-gate
    prefix sum, in a train step).  On a DTensor the sum runs on each
    rank's block under ``local_map``, ``dim`` made whole (as DTensor's
    own rule makes it) and every other shard kept, so its backward
    flips local tensors.  Counted in :data:`per_shard`.  A plain tensor
    takes ``torch.cumsum`` itself, so traced programs do not change.
    """
    import torch
    if not is_dtensor(x):
        return torch.cumsum(x, dim=dim)
    dim %= x.ndim
    spec = _LETTERS[:x.ndim]
    in_pl, out_pl = _local_placements(x.device_mesh, [x], [spec], [spec],
                                      whole=spec[dim])
    per_shard["cumsum"] += 1
    return _run_local(lambda t: torch.cumsum(t, dim=dim), x.device_mesh,
                      [x], in_pl, out_pl)


def top_k(op, x, k: int):
    """``op(x, k)`` for a top-k along the last dim (``layers.top_k``'s
    op), which DTensor has no sharding strategy for.

    On a DTensor it runs on each rank's block under ``local_map``, the
    last dim made whole and every other shard kept (a pending sum made
    whole), as GSPMD partitions ``lax.top_k`` on every dim but the last;
    a stable sort along a whole last dim keeps the tie order.  Counted
    in :data:`per_shard`.  A plain tensor takes ``op`` itself, so traced
    programs do not change.
    """
    if not is_dtensor(x):
        return op(x, k)
    spec = _LETTERS[:x.ndim]
    in_pl, out_pl = _local_placements(x.device_mesh, [x], [spec],
                                      [spec, spec], whole=spec[-1])
    per_shard["top_k"] += 1
    return _run_local(lambda t: op(t, k), x.device_mesh, [x], in_pl,
                      out_pl)


def lookup(fn, ids, table):
    """``fn(ids, table)`` for a lookup of ``table``'s rows at ``ids``
    (``F.embedding``): the global MoE dispatch's token gather.

    On DTensors it runs on each rank's blocks under ``local_map``:
    ``table``'s rows made whole (GSPMD leaves the global dispatch's
    buffers unsharded), its feature dim and the ids kept as
    :func:`_local_placements` keeps them.  A model's embedding table
    goes through :func:`embedding` instead, which keeps the table where
    it lies.  Counted in :data:`per_shard`.  Plain tensors take ``fn``
    itself, so traced programs do not change.
    """
    ref = ids if is_dtensor(ids) else table if is_dtensor(table) else None
    if ref is None:
        return fn(ids, table)
    spec = _LETTERS[:ids.ndim]
    in_pl, out_pl = _local_placements(ref.device_mesh, [ids, table],
                                      [spec, "ZY"], [spec + "Y"],
                                      whole="Z")
    per_shard["lookup"] += 1
    return _run_local(fn, ref.device_mesh, [ids, table], in_pl, out_pl)


def take_along_axis(fn, arr, idx, axis: int):
    """``fn(arr, idx, axis)`` for ``layers.take_along_axis``'s gather of
    ``arr`` and ``idx`` broadcast against each other on every dim but
    ``axis``.

    On DTensors it runs on each rank's blocks under ``local_map``: a dim
    of both stays sharded as :func:`_local_placements` keeps it, a dim
    of size one broadcast against the other's is replicated, the index
    may be sharded on ``axis`` (each rank gathers its own rows) and
    ``arr``'s ``axis`` is made whole.  Counted in :data:`per_shard`.
    Plain tensors take ``fn`` itself, so traced programs do not change.
    """
    ref = arr if is_dtensor(arr) else idx if is_dtensor(idx) else None
    if ref is None:
        return fn(arr, idx, axis)
    axis %= arr.ndim
    spec = _LETTERS[:arr.ndim]

    def letters(x, other):
        return "".join("." if d != axis and x.shape[d] == 1 and
                       other.shape[d] != 1 else c
                       for d, c in enumerate(spec))
    # arr's axis takes a letter of its own, never sharded
    aspec = letters(arr, idx)
    aspec = aspec[:axis] + "Z" + aspec[axis + 1:]
    in_pl, out_pl = _local_placements(ref.device_mesh, [arr, idx],
                                      [aspec, letters(idx, arr)], [spec],
                                      whole="Z")
    per_shard["take_along_axis"] += 1
    return _run_local(lambda a, i: fn(a, i, axis), ref.device_mesh,
                      [arr, idx], in_pl, out_pl)


def scatter_add(fn, base, dim: int, idx, upd):
    """``fn(base, dim, idx, upd)`` for ``layers.scatter_add_rows``'s
    combine: ``base`` (*lead, N, d), ``idx`` (*lead, n), ``upd`` (*lead,
    n, d), the rows of ``upd`` added into ``base`` at ``idx`` along
    ``dim`` (``len(lead)``).

    On DTensors it runs on each rank's blocks under ``local_map``: the
    lead dims and ``d`` stay sharded as :func:`_local_placements` keeps
    them, ``base``'s ``N`` is made whole, and where the mesh dim shards
    the updates' rows ``n`` (their experts) each rank adds its own rows
    into ``base`` and the result is a pending sum, as GSPMD partitions a
    scatter along its update dims; ``base`` then counts on the first
    rank of that mesh dim only (the others add into zeros), and its
    gradient, the cotangent there and zero elsewhere, sums back to the
    cotangent once.  Counted in :data:`per_shard`.  Plain tensors take
    ``fn`` itself, so traced programs do not change.
    """
    import torch
    ref = next((x for x in (base, idx, upd) if is_dtensor(x)), None)
    if ref is None:
        return fn(base, dim, idx, upd)
    mesh = ref.device_mesh
    lead = _LETTERS[:dim]
    # the updates' letters are tried first: a sharded expert dim is kept
    # (each rank adds its own rows) and the index moved to it
    (u_pl, i_pl, b_pl), out_pl = _local_placements(
        mesh, [upd, idx, base], [lead + "nY", lead + "n", lead + "NY"],
        [lead + "NY"], whole="N", linear=0, movable=(1,))
    in_pl = [b_pl, i_pl, u_pl]
    coord = mesh.get_coordinate()
    counts = all(coord[i] == 0 for i, p in enumerate(out_pl[0])
                 if p.is_partial())

    def local(b, i, u):
        # the other ranks add into zeros; a base that takes a gradient
        # stays in their graphs, its gradient there zero (autograd would
        # otherwise run its reduction on one rank only)
        if not counts:
            b = b * 0 if b.requires_grad else torch.zeros_like(b)
        return fn(b, dim, i, u)
    per_shard["scatter_add"] += 1
    return _run_local(local, mesh, [base, idx, upd], in_pl, out_pl)


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
