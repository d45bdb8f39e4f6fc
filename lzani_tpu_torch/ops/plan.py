"""Work plan of the device engines (torch-free): a run's reference rows by
route, their groups and each group's work units. ``all2all_cuda`` plans
a run at its start (``Plan``), the hybrid each group it claims
(``cut_groups``, ``group_units``): the same group gives the same units
on either side. A route is the name ``CudaAll2All.row_path`` gives its
rows; ``"native"`` rows are parsed by the native engine.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .finalize import NO_PAIRS, row_wanted, unit_pairs


class Group(NamedTuple):
    """References dispatched together (r = -1: a dummy padding slot) and
    each one's wanted (queries, output slots)."""
    route: str
    r_list: list
    wanteds: list


class Unit(NamedTuple):
    """One dispatch: group `group` of the plan x the queries [lo, lo +
    width), or (lo None) the gathered rows `qidx`; `pairs` as
    ``finalize.unit_pairs`` gives them (g, r, q, slot, b)."""
    group: int
    lo: int | None
    qidx: np.ndarray | None
    pairs: tuple


class Layout(NamedTuple):
    """A route's cut: G references a group, `width` queries a unit, a
    short last group padded to G, units gathered (``group_units``)."""
    G: int
    width: int
    pad: bool
    gather: bool


def route_rows(paths, filter_csr=None):
    """({path: [(r, (queries, slots))]}: the rows with pairs, by route, in
    row order; the count of rows without a pair, another process's)."""
    rows, idle = {}, 0
    for r, path in enumerate(paths):
        qs, slots = row_wanted(r, len(paths), filter_csr)
        if len(qs):
            rows.setdefault(path, []).append((r, (qs, slots)))
        else:
            idle += 1
    return rows, idle


def cut_groups(route, rows, G, pad):
    """`route`'s ``Group``s of G consecutive `rows` ([(r, wanted)]); with
    `pad`, the last is filled up with dummy slots (r = -1, no pairs)."""
    out = []
    for i0 in range(0, len(rows), G):
        chunk = rows[i0:i0 + G]
        k = G - len(chunk) if pad else 0
        out.append(Group(route, [r for r, _ in chunk] + [-1] * k,
                         [w for _, w in chunk] + [NO_PAIRS] * k))
    return out


def group_units(r_list, wanteds, width, n_pad, gather=False):
    """A group's units, (lo, qidx, pairs) in dispatch order: the windows
    [lo, lo + width) of the n_pad query rows that hold a wanted pair; or,
    with `gather` (a sparse filter), the union of its wanted queries in
    chunks of `width`, a short chunk repeating its last query
    (pallas_engine.py:1545-1560)."""
    out = []
    if not gather:
        for lo in range(0, n_pad, width):
            pairs = unit_pairs(r_list, wanteds, lambda qs: (
                (qs >= lo) & (qs < lo + width), qs - lo))
            if len(pairs[0]):
                out.append((lo, None, pairs))
        return out
    uq = np.unique(np.concatenate([qs for qs, _ in wanteds]))
    for c0 in range(0, len(uq), width):
        chunk = uq[c0:c0 + width]
        idx = np.full(width, chunk[-1], np.int64)
        idx[:len(chunk)] = chunk
        out.append((None, idx, unit_pairs(r_list, wanteds, lambda qs: (
            np.isin(qs, chunk), np.searchsorted(chunk, qs)))))
    return out


class Plan:
    """A run's work from ``route_rows``' `rows` and `idle`: `native` rows;
    the `groups` and `units` of each route of `layouts` ({route:
    ``Layout``}, in that order), a group's units consecutive;
    `total_pairs`; and the Sequences% counter (pallas_engine.py:1575-1580):
    `seqs_done` rows done before any unit drains (rows without pairs or
    units), ``drained`` the rest as their groups' last units drain."""

    def __init__(self, rows, idle, layouts, n_pad):
        self.rows, self.layouts = rows, layouts
        self.native = rows.get("native", [])
        self.groups: list[Group] = []
        self.units: list[Unit] = []
        for route, lay in layouts.items():
            for grp in cut_groups(route, rows.get(route, []), lay.G, lay.pad):
                self.units += [Unit(len(self.groups), *u) for u in
                               group_units(grp.r_list, grp.wanteds,
                                           lay.width, n_pad, lay.gather)]
                self.groups.append(grp)
        self._left = [0] * len(self.groups)
        for u in self.units:
            self._left[u.group] += 1
        self._real = [sum(r >= 0 for r in g.r_list) for g in self.groups]
        self.total_pairs = (sum(len(u.pairs[0]) for u in self.units)
                            + sum(len(w[0]) for _, w in self.native))
        self.seqs_done = idle + sum(
            k for k, left in zip(self._real, self._left) if not left)

    def drained(self, gi: int) -> int:
        """Count a drained unit of group `gi`; the rows it completes."""
        self._left[gi] -= 1
        return self._real[gi] if self._left[gi] == 0 else 0
