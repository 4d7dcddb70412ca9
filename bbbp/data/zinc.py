"""ZINC data layer: tranche readers, per-ID downloader, synthetic generator.

Reference equivalents: ``Descriptors/zinc_download.py`` (D12 — threaded HTTP
fetch of ZINC substances with ID-echo validation, writes zinc_dataset.csv),
``Descriptors/ZINC-downloader-2D-smi.wget`` (D13 — tranche URL list), and the
``.smi`` tranche walker of ``Descriptors/create_descriptors_zinc.py:34-59``.

The downloader needs network access, so it is tested only for URL
construction. The benchmark and the device smoke test use the seeded
synthetic drug-like SMILES generator instead (fragment grammar, validated
against this framework's own parser), labelled by ``tpsa_bbb_labels``.
"""

from __future__ import annotations

import csv
import io
import os
import random
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# tranche / .smi reading
# ---------------------------------------------------------------------------

def iter_smi_file(path: str) -> Iterator[Tuple[str, str]]:
    """Yield (smiles, id) from a .smi file (whitespace-separated, optional
    header line starting with 'smiles')."""
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            if parts[0].lower() in ("smiles", "smile"):
                continue
            smiles = parts[0]
            mol_id = parts[1] if len(parts) > 1 else ""
            yield smiles, mol_id


def iter_smi_dir(path: str) -> Iterator[Tuple[str, str]]:
    """Walk a directory of .smi tranches (reference: create_descriptors_zinc.py:37-43)."""
    for root, _, files in os.walk(path):
        for fn in sorted(files):
            if fn.endswith(".smi"):
                yield from iter_smi_file(os.path.join(root, fn))


def chunked(it: Iterable, size: int) -> Iterator[List]:
    buf: List = []
    for x in it:
        buf.append(x)
        if len(buf) >= size:
            yield buf
            buf = []
    if buf:
        yield buf


def parse_wget_list(path: str) -> List[str]:
    """Extract tranche URLs from a ZINC downloader wget script (D13)."""
    urls = []
    with open(path) as f:
        for line in f:
            for tok in line.split():
                tok = tok.strip("\"'")
                if tok.startswith("http://") or tok.startswith("https://"):
                    urls.append(tok)
    return urls


# ---------------------------------------------------------------------------
# per-ID downloader (D12) — zero-egress guarded
# ---------------------------------------------------------------------------

ZINC_FORMATS = ("smi", "sdf", "csv", "xml", "json")


def zinc_substance_url(zinc_id: str, fmt: str = "smi") -> str:
    zid = zinc_id.strip().upper()
    if not zid.startswith("ZINC"):
        zid = f"ZINC{int(zid):012d}"
    return f"https://zinc15.docking.org/substances/{zid}.{fmt}"


def download_molecule(zinc_id: str, fmt: str = "smi",
                      timeout: float = 10.0) -> Optional[Tuple[str, str]]:
    """Fetch one substance; validates the ID echo like the reference
    (zinc_download.py:19-28). Returns (zinc_id, smiles) or None."""
    import urllib.request

    url = zinc_substance_url(zinc_id, fmt)
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            body = r.read().decode("utf-8", "replace").strip()
    except Exception:
        return None
    parts = body.split()
    if len(parts) >= 2 and parts[1].upper().startswith("ZINC"):
        return parts[1], parts[0]
    return None


def download_dataset(zinc_ids: Sequence[str], out_csv: str = "zinc_dataset.csv",
                     fmt: str = "smi", workers: Optional[int] = None) -> int:
    """Threaded bulk fetch (reference uses ThreadPoolExecutor(2×cpu),
    zinc_download.py:85-94); writes ZINC_ID,SMILES rows; returns count."""
    workers = workers or 2 * (os.cpu_count() or 1)
    n = 0
    with ThreadPoolExecutor(max_workers=workers) as ex, open(out_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["ZINC_ID", "SMILES"])
        futs = {ex.submit(download_molecule, z, fmt): z for z in zinc_ids}
        for fut in as_completed(futs):
            res = fut.result()
            if res is not None:
                w.writerow(res)
                n += 1
    return n


# ---------------------------------------------------------------------------
# synthetic drug-like SMILES (benchmark feedstock; no network needed)
# ---------------------------------------------------------------------------

_CORES = [
    "c1ccccc1", "c1ccncc1", "c1ccc2ccccc2c1", "c1cnc2[nH]ccc2c1", "C1CCNCC1",
    "C1CCOCC1", "c1ccsc1", "c1ccoc1", "c1cnco1", "c1cncs1", "C1CCCCC1",
    "c1cc2ccccc2[nH]1", "c1nccn1C", "C1CNCCN1", "c1ccc(cc1)O", "c1ncncn1",
]
_LINKERS = ["", "C", "CC", "CCC", "C(=O)", "C(=O)N", "OC", "NC", "S(=O)(=O)",
            "C=C", "CNC", "COC", "N(C)C"]
_CAPS = ["C", "CC", "O", "N", "F", "Cl", "Br", "C(F)(F)F", "OC", "N(C)C",
         "C#N", "C(=O)O", "C(=O)OC", "CO", "CN", "S", "OCC", "NCC"]


def synthetic_smiles(n: int, seed: int = 0, validate: bool = True) -> List[str]:
    """Generate n drug-like SMILES: core [+linker+core] + substituents."""
    rng = random.Random(seed)
    out: List[str] = []
    check = None
    if validate:
        from bbbp.chem.smiles import MolFromSmiles as check  # noqa: N813
    while len(out) < n:
        core = rng.choice(_CORES)
        s = core
        if rng.random() < 0.7:
            s = s + rng.choice(_LINKERS) + rng.choice(_CORES)
        for _ in range(rng.randint(0, 3)):
            cap = rng.choice(_CAPS)
            s = s + "" + cap if rng.random() < 0.3 else cap + s
        if check is not None and check(s) is None:
            continue
        out.append(s)
    return out


# BBB+ iff TPSA < 90 Å²: the usual polar-surface cut-off for CNS penetration
TPSA_BBB_CUTOFF = 90.0


def tpsa_bbb_labels(smiles: Sequence[str]) -> np.ndarray:
    """Seeded stand-in for B3DB's BBB+/BBB- labels: int32 [N], 1 iff the
    molecule's TPSA is under ``TPSA_BBB_CUTOFF``; unparseable SMILES get 0."""
    from bbbp.chem.descriptors import _tpsa
    from bbbp.chem.smiles import MolFromSmiles

    out = np.zeros(len(smiles), np.int32)
    for i, s in enumerate(smiles):
        mol = MolFromSmiles(s)
        if mol is not None:
            out[i] = _tpsa(mol) < TPSA_BBB_CUTOFF
    return out
