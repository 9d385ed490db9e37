"""Sharding conflicts, box compatibility, and cross-layer isomorphism
(paper §3.3–3.6).

A *conflict* is an (unordered) pair of dimension-graph nodes — I-only
equivalence classes, "groups" — of the same color that co-annotate at least
one tensor occurrence (def or use).  Multiple sites inducing the same group
pair witness the *same* conflict edge (this is how the paper's Fig. 5d
counts 5 conflicts for the attention block: the div/broadcast/def-d sites
collapse onto one edge each).

Two conflicts are *box-compatible* (§3.5) when some witness of one sits at
a variable's def and a witness of the other at a use of the same variable
at the same dim positions (the M edges def[i]→use[i] form the "box"), and
no *crossing* path exists in the dimension graph.  A crossing path is a
directed M-path from one def-side group to the *other* use-side group that
avoids all conflict endpoints of the color — paths through other conflicts
are fine because the compatibility closure resolves those consistently,
whereas a conflict-free crossing path is independent dataflow that would
force a reshard (paper Fig. 6 middle/right).

The reflexive-symmetric-transitive closure of box-compatibility gives
*compatibility sets*; each admits exactly two resolutions (side 0 / side 1,
oriented consistently through the boxes).  Compatibility sets with
isomorphic signatures (§3.6 — repeated layers) are merged into
*supergroups* resolved by a single bit.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np

from repro_torch.core.nda import NDAResult, Site, UnionFind


@dataclasses.dataclass
class Witness:
    site: Site
    dim_a: int                # dim index carrying group_a
    dim_b: int                # dim index carrying group_b


@dataclasses.dataclass
class Conflict:
    cid: int
    group_a: int              # group_a < group_b (canonical)
    group_b: int
    color: int
    witnesses: list[Witness]

    def endpoints(self) -> tuple[int, int]:
        return (self.group_a, self.group_b)


@dataclasses.dataclass
class CompatSet:
    sid: int
    conflicts: list[Conflict]
    # side assignment: conflict cid -> (group_for_side0, group_for_side1)
    sides: dict[int, tuple[int, int]]
    signature: tuple = ()


@dataclasses.dataclass
class ConflictAnalysis:
    conflicts: list[Conflict]
    compat_sets: list[CompatSet]
    # supergroups after §3.6 isomorphism merging: list of lists of set ids
    supergroups: list[list[int]]
    # color -> supergroup indices whose conflicts touch that color
    color_supergroups: dict[int, list[int]]
    # group -> chosen-side membership helper: see resolution_groups
    _conflict_by_group: dict[int, list[int]] = dataclasses.field(
        default_factory=dict)

    @property
    def num_resolution_bits(self) -> int:
        return len(self.supergroups)

    def resolution_groups(self, bits: int) -> set[int]:
        """Set of groups chosen (shardable) under resolution bitstring;
        the complement endpoints are suppressed."""
        chosen: set[int] = set()
        suppressed: set[int] = set()
        for gi, sg in enumerate(self.supergroups):
            bit = (bits >> gi) & 1
            for sid in sg:
                cs = self.compat_sets[sid]
                for c in cs.conflicts:
                    s0, s1 = cs.sides[c.cid]
                    chosen.add(s1 if bit else s0)
                    suppressed.add(s0 if bit else s1)
        return chosen - (suppressed - chosen)


def _site_conflicts(res: NDAResult, site: Site, colors, groups,
                    by_pair: dict[tuple[int, int], Conflict]) -> None:
    """Record the conflicts witnessed by one site into ``by_pair``."""
    by_color: dict[int, list[int]] = defaultdict(list)
    for i, n in enumerate(site.dims):
        by_color[int(colors[n])].append(i)
    for color, idxs in by_color.items():
        if len(idxs) < 2:
            continue
        for a_pos in range(len(idxs)):
            for b_pos in range(a_pos + 1, len(idxs)):
                i, j = idxs[a_pos], idxs[b_pos]
                ga, gb = int(groups[site.dims[i]]), int(groups[site.dims[j]])
                if ga == gb:
                    # same group twice in one tensor: unresolvable by
                    # group choice; skip (cannot shard either way).
                    continue
                if ga > gb:
                    ga, gb, i, j = gb, ga, j, i
                c = by_pair.get((ga, gb))
                if c is None:
                    c = Conflict(len(by_pair), ga, gb, color, [])
                    by_pair[(ga, gb)] = c
                c.witnesses.append(Witness(site, i, j))


def find_conflicts_reference(res: NDAResult) -> list[Conflict]:
    """The original per-site python walk over every site — kept verbatim
    as the exactness oracle for :func:`find_conflicts` (the vectorized
    path must be bit-identical; see tests/test_fullscale.py)."""
    by_pair: dict[tuple[int, int], Conflict] = {}
    for site in res.all_sites():
        by_color: dict[int, list[int]] = defaultdict(list)
        for i, n in enumerate(site.dims):
            by_color[res.color(n)].append(i)
        for color, idxs in by_color.items():
            if len(idxs) < 2:
                continue
            for a_pos in range(len(idxs)):
                for b_pos in range(a_pos + 1, len(idxs)):
                    i, j = idxs[a_pos], idxs[b_pos]
                    ga, gb = res.group(site.dims[i]), res.group(site.dims[j])
                    if ga == gb:
                        continue
                    if ga > gb:
                        ga, gb, i, j = gb, ga, j, i
                    c = by_pair.get((ga, gb))
                    if c is None:
                        c = Conflict(len(by_pair), ga, gb, color, [])
                        by_pair[(ga, gb)] = c
                    c.witnesses.append(Witness(site, i, j))
    return list(by_pair.values())


def find_conflicts(res: NDAResult) -> list[Conflict]:
    """Conflict detection, vectorized over sites.

    A site can only witness a conflict when two of its dims share a
    color, so the per-site python pair walk is needed for almost no
    sites.  The flat ``(site, dim-color)`` table is built once as numpy
    index arrays; ``np.unique`` finds the (site, color) keys that occur
    twice, and only the few flagged sites run the exact per-site walk —
    in original site order, so conflict ids, witness order, and
    downstream compat sets are bit-identical to
    :func:`find_conflicts_reference`.
    """
    sites = list(res.all_sites())
    colors = res.colors_arr
    groups = res.groups_arr
    site_idx = np.fromiter(
        (k for k, s in enumerate(sites) for _ in s.dims),
        dtype=np.int64,
        count=sum(len(s.dims) for s in sites))
    if site_idx.size == 0:
        return []
    dims = np.fromiter((n for s in sites for n in s.dims),
                       dtype=np.int64, count=site_idx.size)
    # (site, color) composite keys; a site witnesses a conflict only when
    # one of its keys repeats
    keys = site_idx * np.int64(len(colors)) + colors[dims]
    uniq, counts = np.unique(keys, return_counts=True)
    hot = np.unique(uniq[counts >= 2] // np.int64(len(colors)))
    by_pair: dict[tuple[int, int], Conflict] = {}
    for k in hot.tolist():
        _site_conflicts(res, sites[k], colors, groups, by_pair)
    return list(by_pair.values())


def _group_adjacency(res: NDAResult) -> dict[int, set[int]]:
    adj: dict[int, set[int]] = defaultdict(set)
    if not res.m_edges:
        return adj
    groups = res.groups_arr
    edges = np.asarray(res.m_edges, dtype=np.int64)
    gd, gu = groups[edges[:, 0]], groups[edges[:, 1]]
    keep = gd != gu
    pairs = np.unique(np.stack([gd[keep], gu[keep]], axis=1), axis=0)
    for d, u in pairs.tolist():
        adj[int(d)].add(int(u))
    return adj


def _crossing_path(adj, src: int, dst: int, blocked: set[int],
                   limit: int = 50000) -> bool:
    """Directed path src ⇝ dst avoiding `blocked` intermediate nodes."""
    if src == dst:
        return True
    stack = [src]
    seen = {src}
    steps = 0
    while stack and steps < limit:
        cur = stack.pop()
        steps += 1
        for nxt in adj.get(cur, ()):
            if nxt == dst:
                return True
            if nxt in blocked or nxt in seen:
                continue
            seen.add(nxt)
            stack.append(nxt)
    return False


def build_compat_sets(res: NDAResult,
                      conflicts: list[Conflict]) -> list[CompatSet]:
    adj = _group_adjacency(res)
    # all conflict endpoints per color (blocked nodes for crossing checks)
    endpoints_by_color: dict[int, set[int]] = defaultdict(set)
    for c in conflicts:
        endpoints_by_color[c.color].update(c.endpoints())

    # witnesses indexed by (value id, kind)
    def_wit: dict[int, list[tuple[Conflict, Witness]]] = defaultdict(list)
    use_wit: dict[int, list[tuple[Conflict, Witness]]] = defaultdict(list)
    for c in conflicts:
        for w in c.witnesses:
            tgt = def_wit if w.site.kind == "def" else use_wit
            tgt[w.site.value].append((c, w))

    uf = UnionFind()
    ids = [uf.make() for _ in conflicts]
    # box edges with their positional correspondence, for orientation:
    # (cid1, cid2, same_orientation: bool)
    boxes: list[tuple[int, int, bool]] = []

    for vid, dlist in def_wit.items():
        for dc, dw in dlist:
            for uc, uw in use_wit.get(vid, ()):  # uses of the same variable
                if dc.cid == uc.cid:
                    continue
                if {dw.dim_a, dw.dim_b} != {uw.dim_a, uw.dim_b}:
                    continue
                # positional M correspondence: def dim i -> use dim i
                # groups: def(dim_a)=dc.group_a maps to use group at same pos
                if dw.dim_a == uw.dim_a:
                    n, o, l, r = dc.group_a, dc.group_b, uc.group_a, uc.group_b
                    same = True
                else:
                    n, o, l, r = dc.group_a, dc.group_b, uc.group_b, uc.group_a
                    same = False
                blocked = endpoints_by_color[dc.color]
                if _crossing_path(adj, n, r, blocked) or \
                        _crossing_path(adj, o, l, blocked):
                    continue
                uf.union(ids[dc.cid], ids[uc.cid])
                boxes.append((dc.cid, uc.cid, same))

    members: dict[int, list[Conflict]] = defaultdict(list)
    for c in conflicts:
        members[uf.find(ids[c.cid])].append(c)

    box_adj: dict[int, list[tuple[int, bool]]] = defaultdict(list)
    for a, b, same in boxes:
        box_adj[a].append((b, same))
        box_adj[b].append((a, same))

    sets: list[CompatSet] = []
    for _, cs in sorted(members.items(), key=lambda kv: kv[1][0].cid):
        cs_sorted = sorted(cs, key=lambda c: c.cid)
        seed = cs_sorted[0]
        sides: dict[int, tuple[int, int]] = {seed.cid: seed.endpoints()}
        cmap = {c.cid: c for c in cs_sorted}
        queue = [seed.cid]
        while queue:
            cur = queue.pop()
            for nb_cid, same in box_adj.get(cur, ()):
                if nb_cid in sides or nb_cid not in cmap:
                    continue
                nb = cmap[nb_cid]
                s0_cur = sides[cur][0]
                cur_c = cmap[cur]
                # orientation: if cur side0 is cur.group_a, nb side0 is
                # nb.group_a when `same`, else nb.group_b (and vice versa).
                cur_is_a = (s0_cur == cur_c.group_a)
                nb_is_a = cur_is_a if same else not cur_is_a
                sides[nb_cid] = ((nb.group_a, nb.group_b) if nb_is_a
                                 else (nb.group_b, nb.group_a))
                queue.append(nb_cid)
        sets.append(CompatSet(len(sets), cs_sorted, sides))
    return sets


def _set_signature(res: NDAResult, cs: CompatSet) -> tuple:
    sig = []
    for c in cs.conflicts:
        for w in c.witnesses:
            shape = res.prog.types[w.site.value].shape
            sig.append((w.site.kind, w.site.prim, shape,
                        tuple(sorted((w.dim_a, w.dim_b)))))
    return tuple(sorted(sig))


def merge_isomorphic(res: NDAResult,
                     sets: list[CompatSet]) -> list[list[int]]:
    by_sig: dict[tuple, list[int]] = defaultdict(list)
    for cs in sets:
        cs.signature = _set_signature(res, cs)
        by_sig[cs.signature].append(cs.sid)
    return [sorted(v) for _, v in sorted(by_sig.items(),
                                         key=lambda kv: kv[1][0])]


def analyze_conflicts(res: NDAResult) -> ConflictAnalysis:
    conflicts = find_conflicts(res)
    sets = build_compat_sets(res, conflicts)
    supergroups = merge_isomorphic(res, sets)
    color_supergroups: dict[int, list[int]] = defaultdict(list)
    for gi, sg in enumerate(supergroups):
        colors = {c.color for sid in sg for c in sets[sid].conflicts}
        for col in colors:
            if gi not in color_supergroups[col]:
                color_supergroups[col].append(gi)
    return ConflictAnalysis(conflicts, sets, supergroups,
                            dict(color_supergroups))
