"""Kekulization: assign alternating double bonds to aromatic systems.

Needed by the SMILES writer: emitting kekulé forms makes write→parse follow
the same aromaticity-perception path as any kekulé input, so canonical forms
are stable and roundtrips exact (the classic toolkit approach; RDKit does the
same internally).

Each atom's required number of in-system double bonds is derived from valence:
needs = target_valence − (σ bonds + existing π + implicit/explicit H) ≥ 1.
A perfect matching over the 'needs' atoms restricted to aromatic bonds is
found by deterministic backtracking (rank order), which suffices for all
chemically valid aromatic systems at these sizes.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

from bbbp.chem.mol import (
    Mol,
    DEFAULT_VALENCES,
    BOND_AROMATIC,
    BOND_DOUBLE,
    BOND_SINGLE,
)


def _needs_double(mol: Mol, i: int) -> bool:
    a = mol.atoms[i]
    valences = DEFAULT_VALENCES.get(a.z)
    if valences is None:
        return False
    adj = a.charge if a.z in (7, 15) else -abs(a.charge)
    sigma_pi = float(mol.total_h(i))
    for bi in mol.neighbors[i]:
        b = mol.bonds[bi]
        if b.order == BOND_AROMATIC:
            sigma_pi += 1.0           # σ component only; π assigned by matching
        else:
            sigma_pi += b.order_value
    used = math.ceil(sigma_pi - 1e-9)
    for v in valences:
        if v + adj >= used:
            return (v + adj - used) >= 1
    return False


def kekulize(mol: Mol, order_hint: Optional[List[int]] = None
             ) -> Optional[Dict[int, int]]:
    """Return {aromatic bond idx → BOND_SINGLE|BOND_DOUBLE}, or None if no
    perfect matching exists. ``order_hint`` (e.g. canonical ranks) makes the
    matching deterministic under atom relabeling."""
    arom_bonds = [b.idx for b in mol.bonds if b.order == BOND_AROMATIC]
    if not arom_bonds:
        return {}
    needs = {i for i in range(mol.num_atoms)
             if any(mol.bonds[bi].order == BOND_AROMATIC
                    for bi in mol.neighbors[i]) and _needs_double(mol, i)}
    rank = order_hint or list(range(mol.num_atoms))

    # adjacency restricted to aromatic bonds between 'needs' atoms
    adj: Dict[int, List[int]] = {i: [] for i in needs}
    for bi in arom_bonds:
        b = mol.bonds[bi]
        if b.a1 in needs and b.a2 in needs:
            adj[b.a1].append(bi)
            adj[b.a2].append(bi)
    for i in adj:
        adj[i].sort(key=lambda bi: rank[mol.bonds[bi].other(i)])

    matched: Dict[int, int] = {}      # atom -> bond idx
    order = sorted(needs, key=lambda i: rank[i])

    def backtrack(k: int) -> bool:
        while k < len(order) and order[k] in matched:
            k += 1
        if k == len(order):
            return True
        u = order[k]
        for bi in adj[u]:
            v = mol.bonds[bi].other(u)
            if v in matched:
                continue
            matched[u] = bi
            matched[v] = bi
            if backtrack(k + 1):
                return True
            del matched[u]
            del matched[v]
        return False

    if not backtrack(0):
        return None
    double_bonds = set(matched.values())
    return {bi: (BOND_DOUBLE if bi in double_bonds else BOND_SINGLE)
            for bi in arom_bonds}
