"""Chemistry core: SMILES parsing, molecular graphs, fingerprints, depiction.

The execution image has no RDKit, so this subpackage implements the featurization
layer of the reference (reference: Descriptors/create_descriptors.py:13-36,
Descriptors/convert_smiles_2_img.py:19-28) from scratch. A pure-Python reference
implementation lives here; a threaded C++ fast path (bbbp/native) produces
identical outputs for the screening hot loop.
"""

from bbbp.chem.mol import Atom, Bond, Mol
from bbbp.chem.smiles import MolFromSmiles, SmilesParseError
from bbbp.chem.fingerprints import (
    morgan_fingerprint,
    path_fingerprint,
    maccs_fingerprint,
)

__all__ = [
    "Atom",
    "Bond",
    "Mol",
    "MolFromSmiles",
    "SmilesParseError",
    "morgan_fingerprint",
    "path_fingerprint",
    "maccs_fingerprint",
]
