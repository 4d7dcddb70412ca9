"""B3DB-style dataset curation: PubChem resolution, combining, label
reconciliation (components D4-D6, D8-D10).

Reference scripts re-implemented:
- D4/D6/D8 ``B3DB/preprocessing/preprocessing.py:13-160``,
  ``B3DB/cleaning/01_combine_clean_rest_api_v4.py``, ``03_update_CID.py`` —
  PubChem REST lookups (name→CID/SMILES, CID→SMILES, SMILES→CID). This image
  has zero egress, so the client is constructed/testable offline and performs
  I/O only when the network exists.
- D5 ``B3DB/preprocessing/combine_clean.py:22-73`` — merge per-reference
  tables, drop missing SMILES, canonical-SMILES identity (the reference uses
  InChI; no InChI generator exists without RDKit — canonical SMILES from
  bbbp.chem.writer plays that role), split regression/classification.
- D9 ``B3DB/grouping/regression_grouping.py:13-180`` — merge multi-source
  logBB per molecule: tolerance/mode rules, quality groups A-D, drop
  irreconcilable ranges.
- D10 ``B3DB/grouping/classification_grouping.py:24-158`` — label voting.
"""

from __future__ import annotations

import json
import urllib.parse
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd

from bbbp.chem.smiles import MolFromSmiles
from bbbp.chem.writer import MolToSmiles


# ---------------------------------------------------------------------------
# D4/D6/D8 — PubChem REST client (zero-egress gated)
# ---------------------------------------------------------------------------

PUBCHEM_BASE = "https://pubchem.ncbi.nlm.nih.gov/rest/pug"


class PubChemClient:
    """name→CID/SMILES, CID→SMILES, SMILES→CID lookups via PUG REST."""

    def __init__(self, timeout: float = 10.0):
        self.timeout = timeout

    # URL builders (pure; unit-testable offline)
    def url_name_to_cid(self, name: str) -> str:
        return (f"{PUBCHEM_BASE}/compound/name/"
                f"{urllib.parse.quote(name)}/cids/JSON")

    def url_cid_to_smiles(self, cid: int) -> str:
        return (f"{PUBCHEM_BASE}/compound/cid/{int(cid)}/property/"
                f"IsomericSMILES,CanonicalSMILES/JSON")

    def url_smiles_to_cid(self, smiles: str) -> str:
        return (f"{PUBCHEM_BASE}/compound/smiles/"
                f"{urllib.parse.quote(smiles)}/cids/JSON")

    def _get(self, url: str) -> Optional[dict]:
        import urllib.request

        try:
            with urllib.request.urlopen(url, timeout=self.timeout) as r:
                return json.loads(r.read().decode())
        except Exception:
            return None

    def name_to_cid(self, name: str) -> Optional[int]:
        d = self._get(self.url_name_to_cid(name))
        try:
            return int(d["IdentifierList"]["CID"][0])
        except Exception:
            return None

    def cid_to_smiles(self, cid: int) -> Optional[str]:
        d = self._get(self.url_cid_to_smiles(cid))
        try:
            p = d["PropertyTable"]["Properties"][0]
            return p.get("IsomericSMILES") or p.get("CanonicalSMILES")
        except Exception:
            return None

    def smiles_to_cid(self, smiles: str) -> Optional[int]:
        d = self._get(self.url_smiles_to_cid(smiles))
        try:
            return int(d["IdentifierList"]["CID"][0])
        except Exception:
            return None


# ---------------------------------------------------------------------------
# D5 — combining per-reference tables
# ---------------------------------------------------------------------------

def canonical_key(smiles: str) -> Optional[str]:
    """Molecule identity key (canonical SMILES; the reference's InChI role)."""
    mol = MolFromSmiles(smiles)
    return MolToSmiles(mol) if mol is not None else None


def combine_tables(tables: Sequence[pd.DataFrame],
                   smiles_col: str = "SMILES") -> pd.DataFrame:
    """Concatenate source tables, drop rows without parseable SMILES, attach
    canonical identity + source index (reference combine_excels + remove_nan
    + update_inchi, combine_clean.py:22-60)."""
    frames = []
    for si, t in enumerate(tables):
        t = t.copy()
        t["source"] = si
        frames.append(t)
    df = pd.concat(frames, ignore_index=True)
    df = df.dropna(subset=[smiles_col]).reset_index(drop=True)
    keys = [canonical_key(s) for s in df[smiles_col].astype(str)]
    df["canonical_smiles"] = keys
    return df.dropna(subset=["canonical_smiles"]).reset_index(drop=True)


def split_regression_classification(df: pd.DataFrame,
                                    logbb_col: str = "logBB",
                                    label_col: str = "BBB+/BBB-"
                                    ) -> Tuple[pd.DataFrame, pd.DataFrame]:
    """Rows with numeric logBB → regression; rows with only labels →
    classification (reference combine_clean.py:61-73)."""
    has_num = pd.to_numeric(df.get(logbb_col), errors="coerce").notna()
    return (df[has_num].reset_index(drop=True),
            df[~has_num & df.get(label_col).notna()].reset_index(drop=True))


# ---------------------------------------------------------------------------
# D9 — regression label reconciliation
# ---------------------------------------------------------------------------

def reconcile_regression_labels(df: pd.DataFrame,
                                key_col: str = "canonical_smiles",
                                value_col: str = "logBB",
                                tolerance: float = 0.3,
                                max_range: float = 1.0) -> pd.DataFrame:
    """Merge multi-source logBB per molecule with the reference's rules
    (regression_grouping.py:160-180):

    - single source → group A
    - all values within ``tolerance`` → mean, group B
    - range ≤ ``max_range`` → median, group C
    - range > ``max_range`` → dropped (group D, irreconcilable)
    """
    rows = []
    for key, grp in df.groupby(key_col):
        vals = pd.to_numeric(grp[value_col], errors="coerce").dropna().to_numpy()
        if len(vals) == 0:
            continue
        if len(vals) == 1:
            rows.append((key, float(vals[0]), "A", len(vals)))
            continue
        rng = float(vals.max() - vals.min())
        if rng <= tolerance:
            rows.append((key, float(vals.mean()), "B", len(vals)))
        elif rng <= max_range:
            rows.append((key, float(np.median(vals)), "C", len(vals)))
        # else: dropped
    return pd.DataFrame(rows, columns=[key_col, value_col, "group", "n_sources"])


# ---------------------------------------------------------------------------
# D10 — classification label reconciliation (voting)
# ---------------------------------------------------------------------------

def reconcile_classification_labels(df: pd.DataFrame,
                                    key_col: str = "canonical_smiles",
                                    label_col: str = "BBB+/BBB-"
                                    ) -> pd.DataFrame:
    """Majority vote per molecule; unanimous → group A, majority → B,
    ties dropped (classification_grouping.py:24-158 voting loop)."""
    rows = []
    for key, grp in df.groupby(key_col):
        labels = grp[label_col].dropna().astype(str).str.strip()
        pos = int((labels == "BBB+").sum())
        neg = int((labels == "BBB-").sum())
        total = pos + neg
        if total == 0 or pos == neg:
            continue
        label = "BBB+" if pos > neg else "BBB-"
        group = "A" if (pos == 0 or neg == 0) else "B"
        rows.append((key, label, group, total))
    return pd.DataFrame(rows, columns=[key_col, label_col, "group", "n_sources"])
