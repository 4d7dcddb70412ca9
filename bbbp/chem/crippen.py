"""Wildman–Crippen atom-contribution logP and molar refractivity (MR).

The reference relies on RDKit fingerprints only (SURVEY.md §2.2); this module
supplies the classic Crippen descriptors for the beyond-parity descriptor set
used by the regression tree legs and the NN fingerprint branch. Atom typing
follows the published scheme (Wildman & Crippen, J. Chem. Inf. Comput. Sci.
39 (1999) 868–873 — public parameter table): every heavy atom is assigned one
of ~70 environment classes (first-match-wins, like the published SMARTS
order), its implicit/explicit hydrogens one of H1–HS, and logP/MR are the sums
of per-class contributions.

This is a faithful re-typing on this framework's own molecular graph
(bbbp.chem.mol), not a SMARTS engine port; corner-case typing may differ
from RDKit by an atom class here and there, which shifts logP by <~0.2 on
drug-like molecules — irrelevant for its role as a learned-model input.
"""

from __future__ import annotations

from typing import Tuple

from bbbp.chem.mol import (
    BOND_AROMATIC,
    BOND_DOUBLE,
    BOND_SINGLE,
    BOND_TRIPLE,
    Mol,
)

# class -> (logP contribution, MR contribution); published Wildman–Crippen table
PARAMS = {
    "C1": (0.1441, 2.503), "C2": (0.0, 2.433), "C3": (-0.2035, 2.753),
    "C4": (-0.2051, 2.731), "C5": (-0.2783, 5.007), "C6": (0.1551, 3.513),
    "C7": (0.0017, 3.888), "C8": (0.08452, 2.464), "C9": (-0.1444, 2.412),
    "C10": (-0.0516, 2.488), "C11": (0.1193, 2.582), "C12": (-0.0967, 2.576),
    "C13": (-0.5443, 4.041), "C14": (0.0, 3.257), "C15": (0.245, 3.564),
    "C16": (0.198, 3.180), "C17": (0.0, 3.104), "C18": (0.1581, 3.350),
    "C19": (0.2955, 4.346), "C20": (0.2713, 3.904), "C21": (0.136, 3.509),
    "C22": (0.4619, 4.067), "C23": (0.5437, 3.853), "C24": (0.1893, 2.673),
    "C25": (-0.8186, 3.135), "C26": (0.2640, 4.305), "C27": (0.2148, 2.693),
    "CS": (0.08129, 3.243),
    "H1": (0.1230, 1.057), "H2": (-0.2677, 1.395), "H3": (0.2142, 0.9627),
    "H4": (0.2980, 1.805), "HS": (0.1125, 1.112),
    "N1": (-1.0190, 2.262), "N2": (-0.7096, 2.173), "N3": (-1.0270, 2.827),
    "N4": (-0.5188, 3.000), "N5": (0.08387, 1.757), "N6": (0.1836, 2.428),
    "N7": (-0.3187, 1.839), "N8": (-0.4458, 2.819), "N9": (0.01508, 1.725),
    "N10": (-1.950, 0.0), "N11": (-0.3239, 2.202), "N12": (-1.119, 0.0),
    "N13": (-0.3396, 0.2604), "N14": (0.2887, 3.359), "NS": (-0.4806, 2.134),
    "O1": (0.1552, 1.080), "O2": (-0.2893, 0.8238), "O3": (-0.0684, 1.085),
    "O4": (-0.4195, 1.182), "O5": (0.0335, 3.367), "O6": (-0.3339, 0.7774),
    "O7": (-1.189, 0.0), "O8": (0.1788, 3.135), "O9": (-0.1526, 0.0),
    "O10": (0.1129, 0.2215), "O11": (0.4833, 0.389), "O12": (-1.326, 0.0),
    "OS": (-0.1188, 0.6865),
    "F": (0.4202, 1.108), "Cl": (0.6895, 5.853), "Br": (0.8456, 8.927),
    "I": (0.8857, 14.02), "Hal": (-2.996, 0.0),
    "P": (0.8612, 6.920),
    "S1": (0.6482, 7.591), "S2": (-0.0024, 7.365), "S3": (0.6237, 6.691),
    "Me1": (-0.3808, 5.754), "Me2": (-0.0025, 0.0),
}

_ME1 = {3, 11, 19, 37, 55, 4, 12, 20, 38, 56}            # alkali + alkaline earth
_HETERO_FOR_C = {7, 8, 15, 16, 9, 17, 35, 53}            # N,O,P,S,F,Cl,Br,I
_HALOGENS = {9: "F", 17: "Cl", 35: "Br", 53: "I"}


def _heavy_neighbors(mol: Mol, i: int):
    return [j for j in mol.atom_neighbors(i) if mol.atoms[j].z > 1]


def _bond_orders(mol: Mol, i: int):
    return [mol.bonds[bi].order for bi in mol.neighbors[i]
            if mol.atoms[mol.bonds[bi].other(i)].z > 1]


def _is_sp3_c(mol: Mol, i: int) -> bool:
    a = mol.atoms[i]
    return (a.z == 6 and not a.aromatic
            and all(o == BOND_SINGLE for o in _bond_orders(mol, i)))


def _type_carbon(mol: Mol, i: int) -> str:
    a = mol.atoms[i]
    nbrs = _heavy_neighbors(mol, i)
    orders = _bond_orders(mol, i)
    h = mol.total_h(i)
    if a.aromatic:
        # aromatic carbon classes C13–C25
        arom_nbrs = [j for j in nbrs if mol.atoms[j].aromatic]
        plain_nbrs = [j for j in nbrs if not mol.atoms[j].aromatic]
        for j in plain_nbrs:
            b = mol.get_bond(i, j)
            zj = mol.atoms[j].z
            if b.order == BOND_DOUBLE and zj in (6, 7, 8):
                return "C25"                         # exocyclic =C/=N/=O
        if h == 0 and plain_nbrs:
            j = plain_nbrs[0]
            zj = mol.atoms[j].z
            if zj in _HALOGENS:
                return {9: "C14", 17: "C15", 35: "C16", 53: "C17"}[zj]
            if zj == 6:
                return "C21"
            if zj == 7:
                return "C22"
            if zj == 8:
                return "C23"
            if zj == 16:
                return "C24"
            return "C13"                             # attached to exotic atom
        if h >= 1:
            return "C18"                             # [cH]
        if len(arom_nbrs) >= 3:
            return "C19"                             # aromatic bridgehead
        # c(:a)(:a)-a : biaryl single bond to another aromatic system
        if plain_nbrs and mol.atoms[plain_nbrs[0]].aromatic:
            return "C20"
        return "C20" if not plain_nbrs else "C21"
    # aliphatic carbon
    if any(o == BOND_TRIPLE for o in orders):
        return "C7"
    if any(o == BOND_DOUBLE for o in orders):
        dbl = [j for j in nbrs
               if mol.get_bond(i, j).order == BOND_DOUBLE]
        if any(mol.atoms[j].z != 6 for j in dbl):
            return "C5"                              # C=[hetero]
        if any(mol.atoms[j].aromatic for j in nbrs):
            return "C26"                             # vinyl on aromatic
        return "C6"
    # sp3
    if any(mol.atoms[j].aromatic for j in nbrs):
        if h >= 3:
            arom = [j for j in nbrs if mol.atoms[j].aromatic]
            return "C8" if mol.atoms[arom[0]].z == 6 else "C9"
        if h == 2:
            return "C10"
        if h == 1:
            return "C11"
        return "C12"
    zs = {mol.atoms[j].z for j in nbrs}
    if zs & _HETERO_FOR_C:
        return "C3" if h >= 2 else "C4"
    if zs <= {6}:
        return "C1" if h >= 2 else "C2"              # CH4/CH3C/CH2(C)C vs CH/C
    return "C27"                                     # bonded to exotic atom


def _type_nitrogen(mol: Mol, i: int) -> str:
    a = mol.atoms[i]
    nbrs = _heavy_neighbors(mol, i)
    orders = _bond_orders(mol, i)
    h = mol.total_h(i)
    if a.aromatic:
        return "N12" if a.charge > 0 else "N11"
    if a.charge > 0:
        if h >= 1:
            return "N10"
        if any(o == BOND_TRIPLE for o in orders):
            return "N14"
        return "N13"
    if a.charge < 0:
        return "NS"
    if any(o == BOND_TRIPLE for o in orders):
        return "N9"
    if any(o == BOND_DOUBLE for o in orders):
        return "N5" if h >= 1 else "N6"
    any_arom = any(mol.atoms[j].aromatic for j in nbrs)
    if h >= 2:
        return "N3" if any_arom else "N1"
    if h == 1:
        return "N4" if any_arom else "N2"
    return "N8" if any_arom else "N7"


def _type_oxygen(mol: Mol, i: int) -> str:
    a = mol.atoms[i]
    nbrs = _heavy_neighbors(mol, i)
    h = mol.total_h(i)
    if a.aromatic:
        return "O1"
    if a.charge < 0:
        if not nbrs:
            return "O7"
        zj = mol.atoms[nbrs[0]].z
        if zj == 7:
            return "O5"
        if zj == 16:
            return "O6"
        if zj == 6:
            # carboxylate: C has another =O
            c = nbrs[0]
            for j in _heavy_neighbors(mol, c):
                if j != i and mol.atoms[j].z == 8 \
                        and mol.get_bond(c, j).order == BOND_DOUBLE:
                    return "O12"
        return "O7"
    dbl = [j for j in nbrs if mol.get_bond(i, j).order == BOND_DOUBLE]
    if dbl:
        j = dbl[0]
        zj = mol.atoms[j].z
        if zj in (7, 8):
            return "O5"
        if zj == 16:
            return "O6"
        if mol.atoms[j].aromatic:
            return "O8"
        if zj == 6:
            others = [k for k in _heavy_neighbors(mol, j) if k != i]
            if any(mol.atoms[k].aromatic for k in others):
                return "O10"
            non_c = [k for k in others if mol.atoms[k].z != 6]
            if len(others) == 2 and len(non_c) == 2:
                return "O11"
            return "O9"
        return "OS"
    if h >= 1:
        return "O2"                                  # alcohol / acid OH
    if len(nbrs) == 2:
        return "O4" if any(mol.atoms[j].aromatic for j in nbrs) else "O3"
    return "OS"


def _type_h_on(mol: Mol, i: int) -> str:
    """Class of hydrogens attached to heavy atom i."""
    a = mol.atoms[i]
    if a.z == 6:
        return "H1"
    if a.z == 7:
        return "H3"
    if a.z == 8:
        nbrs = _heavy_neighbors(mol, i)
        if not nbrs:
            return "H2"                              # water
        x = mol.atoms[nbrs[0]]
        if x.z == 7:
            return "H3"                              # H-O-N
        if x.z in (8, 16):
            return "H4"                              # peroxide / H-O-S
        if x.z == 6:
            if x.aromatic or _is_sp3_c(mol, nbrs[0]):
                return "H2"                          # alcohol / phenol
            # H-O-C=[C,N,O,S] : acid / enol
            for j in _heavy_neighbors(mol, nbrs[0]):
                b = mol.get_bond(nbrs[0], j)
                if b.order == BOND_DOUBLE and mol.atoms[j].z in (6, 7, 8, 16):
                    return "H4"
            return "H2"
        return "H2"
    return "H2"                                      # S-H, P-H, ...


def atom_type(mol: Mol, i: int) -> str:
    a = mol.atoms[i]
    z = a.z
    if z == 6:
        return _type_carbon(mol, i)
    if z == 7:
        return _type_nitrogen(mol, i)
    if z == 8:
        return _type_oxygen(mol, i)
    if z == 16:
        if a.aromatic:
            return "S3"
        return "S2" if a.charge != 0 else "S1"
    if z == 15:
        return "P"
    if z in _HALOGENS:
        return _HALOGENS[z] if a.charge == 0 else "Hal"
    if z == 1:
        return "HS"
    if z in _ME1:
        return "Me1"
    return "Me2"


def crippen_logp_mr(mol: Mol) -> Tuple[float, float]:
    """Molecule-level (logP, MR) as sums of atom + hydrogen contributions."""
    logp = 0.0
    mr = 0.0
    for a in mol.atoms:
        t = atom_type(mol, a.idx)
        lp, m = PARAMS[t]
        logp += lp
        mr += m
        if a.z > 1:
            nh = mol.total_h(a.idx)
            if nh:
                ht = _type_h_on(mol, a.idx)
                hlp, hm = PARAMS[ht]
                logp += nh * hlp
                mr += nh * hm
    return logp, mr
