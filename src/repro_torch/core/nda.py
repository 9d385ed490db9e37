"""Named Dimension Analysis (paper §3, Fig. 3).

Every tensor *definition* and every tensor *use* gets a vector of fresh
dimension-name nodes.  Two relations are built over these nodes:

- ``I`` (identities): per-primitive sharding rules — e.g. for
  ``matmul(x, y) : [a1, a2]`` we add ``a1 ≗ x_use[0]``, ``a2 ≗ y_use[1]``,
  ``x_use[1] ≗ y_use[0]``.
- ``M`` (def→use map): for each use of a variable, edges from the def's
  names to the fresh names of that use.

Union over ``I ∪ M`` gives **colors** — sets of dimensions that must be
sharded identically (paper Fig. 2/4c).  Union over ``I`` only gives
**groups**; ``M`` projected over groups is the **dimension graph** used for
conflict analysis (paper §3.3–3.6, implemented in conflicts.py).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.ir import Op, Program
from repro_torch.kernels import registry as kernel_registry


class UnionFind:
    __slots__ = ("parent", "rank", "version")

    def __init__(self) -> None:
        self.parent: list[int] = []
        self.rank: list[int] = []
        # bumped on every structural change; lets callers cache
        # roots_array() results and know when they went stale
        self.version: int = 0

    def make(self) -> int:
        self.parent.append(len(self.parent))
        self.rank.append(0)
        self.version += 1
        return len(self.parent) - 1

    def find(self, x: int) -> int:
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return
        if self.rank[ra] < self.rank[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        if self.rank[ra] == self.rank[rb]:
            self.rank[ra] += 1
        self.version += 1

    def roots_array(self) -> np.ndarray:
        """Root of every node at once, by vectorized pointer jumping.

        ``parent[parent]`` squares the pointer paths, so the whole forest
        resolves in O(log depth) numpy passes instead of one python walk
        per node — identical roots to :meth:`find` (which compresses to
        the same representative).
        """
        parent = np.asarray(self.parent, dtype=np.int64)
        if parent.size == 0:
            return parent
        while True:
            grand = parent[parent]
            if np.array_equal(grand, parent):
                return parent
            parent = grand


@dataclasses.dataclass
class Site:
    """One annotated occurrence of a tensor: a def or a use."""
    kind: str                 # "def" | "use"
    op_index: int             # -1 for program inputs / synthetic defs
    slot: int                 # operand slot (use) or result slot (def)
    value: int                # value id
    dims: list[int]           # dim-name node ids
    prim: str = ""            # owning op primitive (use) / producer (def)


class NDAResult:
    def __init__(self, prog: Program) -> None:
        self.prog = prog
        self.uf_i = UnionFind()       # identities I only  -> "groups"
        self.uf_im = UnionFind()      # I ∪ M              -> "colors"
        self.m_edges: list[tuple[int, int]] = []   # def-dim-node -> use-dim-node
        self.def_site: dict[int, Site] = {}
        self.use_sites: list[Site] = []
        self.node_sizes: dict[int, int] = {}        # node -> dim size
        # cached vectorized root arrays (see colors_arr / groups_arr)
        self._colors_arr: np.ndarray | None = None
        self._groups_arr: np.ndarray | None = None
        self._colors_version = -1
        self._groups_version = -1

    # -- node allocation --------------------------------------------------

    def _fresh(self, size: int) -> int:
        a = self.uf_i.make()
        b = self.uf_im.make()
        assert a == b
        self.node_sizes[a] = size
        return a

    def fresh_dims(self, shape) -> list[int]:
        return [self._fresh(int(s)) for s in shape]

    def unify(self, a: int, b: int) -> None:
        """Add identity a ≗ b (to both I and I∪M)."""
        self.uf_i.union(a, b)
        self.uf_im.union(a, b)

    def m_edge(self, d: int, u: int) -> None:
        self.m_edges.append((d, u))
        self.uf_im.union(d, u)

    # -- results ----------------------------------------------------------

    @property
    def colors_arr(self) -> np.ndarray:
        """node -> color root, as one numpy array (lazily recomputed
        whenever the underlying union-find changed)."""
        if self._colors_arr is None or \
                self._colors_version != self.uf_im.version:
            self._colors_arr = self.uf_im.roots_array()
            self._colors_version = self.uf_im.version
        return self._colors_arr

    @property
    def groups_arr(self) -> np.ndarray:
        """node -> group root, as one numpy array (lazily recomputed
        whenever the underlying union-find changed)."""
        if self._groups_arr is None or \
                self._groups_version != self.uf_i.version:
            self._groups_arr = self.uf_i.roots_array()
            self._groups_version = self.uf_i.version
        return self._groups_arr

    def color(self, node: int) -> int:
        return self.uf_im.find(node)

    def group(self, node: int) -> int:
        return self.uf_i.find(node)

    def all_sites(self):
        yield from self.def_site.values()
        yield from self.use_sites

    def colors_of_value(self, vid: int) -> list[int]:
        return [self.color(n) for n in self.def_site[vid].dims]

    def color_summary(self) -> dict[int, list[tuple[int, int]]]:
        """color -> list of (value_id, dim_index) over def sites."""
        colors = self.colors_arr
        out: dict[int, list[tuple[int, int]]] = {}
        for vid, site in self.def_site.items():
            for i, n in enumerate(site.dims):
                out.setdefault(int(colors[n]), []).append((vid, i))
        return out


# ---------------------------------------------------------------------------
# per-primitive rules
# ---------------------------------------------------------------------------

_REDUCE_PRIMS = {
    "reduce_sum", "reduce_max", "reduce_min", "reduce_prod", "reduce_and",
    "reduce_or", "reduce_xor", "argmax", "argmin",
}

_CUM_PRIMS = {"cumsum", "cumprod", "cummax", "cummin", "cumlogsumexp"}


def _rule_dot_general(res: NDAResult, op: Op, use, dfs) -> None:
    (lc, rc), (lb, rb) = op.params["dimension_numbers"]
    lhs, rhs = use[0], use[1]
    out = dfs[0]
    nl, nr = len(lhs), len(rhs)
    free_l = [i for i in range(nl) if i not in lc and i not in lb]
    free_r = [i for i in range(nr) if i not in rc and i not in rb]
    k = 0
    for i, j in zip(lb, rb):
        res.unify(out[k], lhs[i])
        res.unify(out[k], rhs[j])
        k += 1
    for i in free_l:
        res.unify(out[k], lhs[i])
        k += 1
    for j in free_r:
        res.unify(out[k], rhs[j])
        k += 1
    for i, j in zip(lc, rc):
        res.unify(lhs[i], rhs[j])


def _rule_transpose(res: NDAResult, op: Op, use, dfs) -> None:
    perm = op.params["permutation"]
    for i, p in enumerate(perm):
        res.unify(dfs[0][i], use[0][p])


def _rule_broadcast_in_dim(res: NDAResult, op: Op, use, dfs) -> None:
    bdims = op.params["broadcast_dimensions"]
    in_t = res.prog.types[op.operands[0]]
    out_t = res.prog.types[op.results[0]]
    for j, bd in enumerate(bdims):
        if in_t.shape[j] == out_t.shape[bd]:
            res.unify(dfs[0][bd], use[0][j])


def _rule_reduce(res: NDAResult, op: Op, use, dfs) -> None:
    axes = set(op.params.get("axes", ()))
    out = dfs[0]
    k = 0
    for i in range(len(use[0])):
        if i in axes:
            continue
        if k < len(out):
            res.unify(out[k], use[0][i])
        k += 1


def _rule_reshape(res: NDAResult, op: Op, use, dfs) -> None:
    """Identify dims across a reshape only for 1:1 size-preserved segments."""
    in_shape = res.prog.types[op.operands[0]].shape
    out_shape = res.prog.types[op.results[0]].shape
    # strip size-1 dims bookkeeping: walk both shapes greedily
    i = j = 0
    while i < len(in_shape) and j < len(out_shape):
        if in_shape[i] == out_shape[j]:
            res.unify(dfs[0][j], use[0][i])
            i += 1
            j += 1
            continue
        # advance the side with the smaller cumulative product until match
        pi, pj = in_shape[i], out_shape[j]
        ii, jj = i + 1, j + 1
        while pi != pj:
            if pi < pj:
                if ii >= len(in_shape):
                    return
                pi *= in_shape[ii]
                ii += 1
            else:
                if jj >= len(out_shape):
                    return
                pj *= out_shape[jj]
                jj += 1
        # dims i..ii-1 merged into j..jj-1 — a split/merge, no identity,
        # except: if the MAJOR-most factor matches in size, identify it
        # (sharding the major factor of a merged dim is layout-preserving).
        if in_shape[i] == out_shape[j]:
            res.unify(dfs[0][j], use[0][i])
        i, j = ii, jj


def _rule_concatenate(res: NDAResult, op: Op, use, dfs) -> None:
    d = op.params["dimension"]
    for u in use:
        for i in range(len(u)):
            if i != d:
                res.unify(dfs[0][i], u[i])


def _rule_slice_like(res: NDAResult, op: Op, use, dfs) -> None:
    """slice / dynamic_slice: identify full-size dims only."""
    in_t = res.prog.types[op.operands[0]]
    out_t = res.prog.types[op.results[0]]
    if in_t.rank != out_t.rank:
        return
    for i in range(in_t.rank):
        if in_t.shape[i] == out_t.shape[i]:
            res.unify(dfs[0][i], use[0][i])


def _rule_dynamic_update_slice(res: NDAResult, op: Op, use, dfs) -> None:
    operand_t = res.prog.types[op.operands[0]]
    update_t = res.prog.types[op.operands[1]]
    for i in range(operand_t.rank):
        res.unify(dfs[0][i], use[0][i])
        if update_t.rank == operand_t.rank and \
                update_t.shape[i] == operand_t.shape[i]:
            res.unify(dfs[0][i], use[1][i])


def _rule_pad(res: NDAResult, op: Op, use, dfs) -> None:
    cfg = op.params["padding_config"]
    for i, (lo, hi, interior) in enumerate(cfg):
        if lo == 0 and hi == 0 and interior == 0:
            res.unify(dfs[0][i], use[0][i])


def _rule_rev(res: NDAResult, op: Op, use, dfs) -> None:
    rev_dims = set(op.params["dimensions"])
    for i in range(len(use[0])):
        if i not in rev_dims:
            res.unify(dfs[0][i], use[0][i])


def _rule_squeeze(res: NDAResult, op: Op, use, dfs) -> None:
    sq = set(op.params["dimensions"])
    k = 0
    for i in range(len(use[0])):
        if i in sq:
            continue
        res.unify(dfs[0][k], use[0][i])
        k += 1


def _rule_expand_dims(res: NDAResult, op: Op, use, dfs) -> None:
    new = set(op.params["dimensions"])
    k = 0
    for i in range(len(dfs[0])):
        if i in new:
            continue
        res.unify(dfs[0][i], use[0][k])
        k += 1


def _rule_cum(res: NDAResult, op: Op, use, dfs) -> None:
    ax = op.params.get("axis", 0)
    for i in range(len(use[0])):
        if i != ax:
            res.unify(dfs[0][i], use[0][i])


def _rule_gather(res: NDAResult, op: Op, use, dfs) -> None:
    """Common-case rule: batch dims of output ≗ index dims; offset dims with
    full slice size ≗ operand dims."""
    dn = op.params["dimension_numbers"]
    operand_t = res.prog.types[op.operands[0]]
    out_rank = len(dfs[0])
    offset_dims = list(dn.offset_dims)
    collapsed = set(dn.collapsed_slice_dims)
    slice_sizes = op.params.get("slice_sizes", ())
    batch_out = [i for i in range(out_rank) if i not in offset_dims]
    idx_dims = use[1]
    # index batch dims: all index dims except the trailing index-vector dim
    for k, od in enumerate(batch_out):
        if k < len(idx_dims) - 1 or (len(idx_dims) >= 1 and k < len(idx_dims)):
            if k < len(idx_dims):
                res.unify(dfs[0][od], idx_dims[k])
    # offset dims map in order to non-collapsed operand dims
    non_collapsed = [i for i in range(operand_t.rank) if i not in collapsed]
    for od, opd in zip(offset_dims, non_collapsed):
        if slice_sizes and slice_sizes[opd] == operand_t.shape[opd]:
            res.unify(dfs[0][od], use[0][opd])


def _rule_scatter(res: NDAResult, op: Op, use, dfs) -> None:
    operand_t = res.prog.types[op.operands[0]]
    # result ≗ operand on all dims
    for i in range(operand_t.rank):
        res.unify(dfs[0][i], use[0][i])
    dn = op.params.get("dimension_numbers")
    if dn is None:
        return
    upd = use[2] if len(use) > 2 else None
    if upd is None:
        return
    uwd = list(dn.update_window_dims)
    inserted = set(dn.inserted_window_dims)
    non_inserted = [i for i in range(operand_t.rank) if i not in inserted]
    upd_t = res.prog.types[op.operands[2]]
    for wd, opd in zip(uwd, non_inserted):
        if wd < upd_t.rank and upd_t.shape[wd] == operand_t.shape[opd]:
            res.unify(upd[wd], use[0][opd])


def _rule_conv(res: NDAResult, op: Op, use, dfs) -> None:
    dn = op.params["dimension_numbers"]
    lhs_spec, rhs_spec, out_spec = dn
    # batch dim and feature dims
    res.unify(dfs[0][out_spec[0]], use[0][lhs_spec[0]])       # N
    res.unify(dfs[0][out_spec[1]], use[1][rhs_spec[0]])       # C_out
    res.unify(use[0][lhs_spec[1]], use[1][rhs_spec[1]])       # C_in contraction


def _rule_sort(res: NDAResult, op: Op, use, dfs) -> None:
    d = op.params.get("dimension", len(use[0]) - 1)
    for r, u in zip(dfs, use):
        for i in range(len(u)):
            if i != d:
                res.unify(r[i], u[i])


def _rule_top_k(res: NDAResult, op: Op, use, dfs) -> None:
    # all but last dim identified; last (k) dim fresh
    for r in dfs:
        for i in range(len(use[0]) - 1):
            res.unify(r[i], use[0][i])


def _rule_split(res: NDAResult, op: Op, use, dfs) -> None:
    ax = op.params.get("axis", op.params.get("dimension", 0))
    for r in dfs:
        for i in range(len(use[0])):
            if i != ax:
                res.unify(r[i], use[0][i])


def _rule_kernel(res: NDAResult, op: Op, use, dfs) -> None:
    """Fused kernel sites: unify all dims sharing a registry role name.

    The registry (``repro_torch.kernels.registry``) assigns every operand and
    result dim of a fused op a role (``batch``, ``heads``, ``q_seq``,
    ...); equal roles must shard identically, so their name nodes join
    one color.  This is the whole sharding contract of the kernel — the
    internals are never inlined, and blocked roles are kept out of the
    action space by ``core.actions``.
    """
    spec = kernel_registry.spec_for_prim(op.prim)
    if spec is None:
        return
    rep: dict[str, int] = {}
    for roles, dims in list(zip(spec.operand_roles, use)) + \
            list(zip(spec.result_roles, dfs)):
        for role, node in zip(roles, dims):
            if role in rep:
                res.unify(rep[role], node)
            else:
                rep[role] = node


_STRUCTURAL_RULES = {
    "dot_general": _rule_dot_general,
    "transpose": _rule_transpose,
    "broadcast_in_dim": _rule_broadcast_in_dim,
    "reshape": _rule_reshape,
    "concatenate": _rule_concatenate,
    "slice": _rule_slice_like,
    "dynamic_slice": _rule_slice_like,
    "dynamic_update_slice": _rule_dynamic_update_slice,
    "pad": _rule_pad,
    "rev": _rule_rev,
    "squeeze": _rule_squeeze,
    "expand_dims": _rule_expand_dims,
    "gather": _rule_gather,
    "scatter": _rule_scatter,
    "scatter-add": _rule_scatter,
    "scatter_add": _rule_scatter,
    "scatter-mul": _rule_scatter,
    "scatter-max": _rule_scatter,
    "scatter-min": _rule_scatter,
    "conv_general_dilated": _rule_conv,
    "sort": _rule_sort,
    "top_k": _rule_top_k,
    "split": _rule_split,
}
for p in _REDUCE_PRIMS:
    _STRUCTURAL_RULES[p] = _rule_reduce
for p in _CUM_PRIMS:
    _STRUCTURAL_RULES[p] = _rule_cum
for _spec in kernel_registry.KERNELS.values():
    _STRUCTURAL_RULES[_spec.prim] = _rule_kernel


def _rule_default(res: NDAResult, op: Op, use, dfs) -> None:
    """Elementwise default: identify dims across all same-shape operands and
    results.  Sound for every rank-preserving pointwise primitive."""
    out_t = res.prog.types[op.results[0]]
    for r, rv in zip(dfs, op.results):
        rt = res.prog.types[rv]
        if rt.shape != out_t.shape:
            continue
        for u, uv in zip(use, op.operands):
            ut = res.prog.types[uv]
            if ut.shape == out_t.shape:
                for i in range(len(u)):
                    res.unify(r[i], u[i])
        if rv != op.results[0]:
            for i in range(len(r)):
                res.unify(r[i], dfs[0][i])


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def run_nda(prog: Program) -> NDAResult:
    res = NDAResult(prog)
    # def sites for every value (inputs, literals, synthetic, op results get
    # theirs when the op is visited; create lazily here for the rest).

    def ensure_def(vid: int, op_index: int = -1, slot: int = 0,
                   prim: str = "") -> Site:
        site = res.def_site.get(vid)
        if site is None:
            site = Site("def", op_index, slot, vid,
                        res.fresh_dims(prog.types[vid].shape), prim)
            res.def_site[vid] = site
        return site

    for op_index, op in enumerate(prog.ops):
        use_dims: list[list[int]] = []
        for slot, vid in enumerate(op.operands):
            d = ensure_def(vid)
            u = Site("use", op_index, slot, vid,
                     res.fresh_dims(prog.types[vid].shape), op.prim)
            res.use_sites.append(u)
            for dn, un in zip(d.dims, u.dims):
                res.m_edge(dn, un)
            use_dims.append(u.dims)
        def_dims: list[list[int]] = []
        for slot, vid in enumerate(op.results):
            dsite = Site("def", op_index, slot, vid,
                         res.fresh_dims(prog.types[vid].shape), op.prim)
            res.def_site[vid] = dsite
            def_dims.append(dsite.dims)
        rule = _STRUCTURAL_RULES.get(op.prim, _rule_default)
        rule(res, op, use_dims, def_dims)

    # program inputs / unused values
    for vid in prog.types:
        ensure_def(vid)

    # structural value links (scan carries, cond branches, xs slicing)
    for va, vb, off in prog.value_links:
        da = ensure_def(va).dims
        db = ensure_def(vb).dims
        for na, nb in zip(da[off:], db):
            res.unify(na, nb)

    return res
