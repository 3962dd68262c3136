"""Packed binary fingerprints and Tanimoto distance (the metric layer).

The accelerator's replacement for usearch's b1-packed storage + Tanimoto
popcount metric (reference call sites: README.md:47-53,
examples/DUDEZ_example.ipynb:92-118). :mod:`rad_tpu.fp.backend` decides
which implementation serves a platform.
"""

from rad_tpu.fp.pack import (
    pack_fingerprints,
    unpack_fingerprints,
    popcount,
    popcount_rows,
    random_fingerprints,
    smiles_fingerprint,
    smiles_fingerprints,
)
from rad_tpu.fp.tanimoto import (
    tanimoto_distance,
    tanimoto_matrix,
    bruteforce_topk,
)

__all__ = [
    "pack_fingerprints",
    "unpack_fingerprints",
    "popcount",
    "popcount_rows",
    "random_fingerprints",
    "smiles_fingerprint",
    "smiles_fingerprints",
    "tanimoto_distance",
    "tanimoto_matrix",
    "bruteforce_topk",
]
