"""Combinatorial drug-like SMILES library with an additive SAR score model.

Provides real molecular structures (valid SMILES over scaffolds x
substituents, all parseable by rad_tpu.chem.parse_smiles) for the
real-chemistry enrichment validation: the DUDE-Z
protocol needs (a) a library of structures, (b) per-molecule docking-like
scores, (c) fingerprints of the structures
(/root/reference/examples/DUDEZ_example.ipynb:92-118, 359-408). With no
RDKit or network in this environment, real DUDE-Z data is unreachable;
this module supplies the structural half honestly — the fingerprints ARE
Morgan/ECFP of real molecular graphs, and the score model is an additive
fragment-contribution SAR (each scaffold/substituent carries a latent
energy term; the molecule's score is their sum plus noise) — the standard
generative model for why 2D similarity predicts docking scores at all.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

__all__ = ["make_smiles_library", "SCAFFOLDS", "SUBSTITUENTS"]

# each scaffold has 1-2 substitution sites marked {0}/{1}; all expansions
# are valid aromatic-form SMILES for the in-tree parser
SCAFFOLDS: Tuple[str, ...] = (
    "c1ccc({0})cc1",                 # mono-sub benzene
    "c1ccc({0})c({1})c1",            # ortho-disub benzene
    "c1cc({0})cc({1})c1",            # meta-disub benzene
    "c1cc({0})ccc1{1}",              # para-disub benzene
    "c1cc({0})c2ccccc2c1",           # naphthalene
    "c1cc({0})cnc1",                 # pyridine
    "c1cc({0})ncc1{1}",              # disub pyridine
    "c1cc({0})sc1",                  # thiophene
    "c1cc({0})oc1",                  # furan
    "c1cc({0})[nH]c1",               # pyrrole
    "C1CCN({0})CC1",                 # N-sub piperidine
    "C1CCC({0})CC1",                 # cyclohexane
    "c1ccc(N({0})C(=O)c2ccccc2)cc1",  # benzanilide core
    "c1ccc(Oc2ccc({0})cc2)cc1",      # diphenyl ether
    "c1ccc(CN({0})C(=O)C)cc1",       # benzyl acetamide
    "c1cnc2[nH]ccc2c1",              # 7-azaindole (no sites)
    "c1c({0})cc({1})cc1{2}",         # trisub benzene
    "c1c({0})cnc({1})c1",            # disub pyridine (2,4)
    "c1ccc(-c2ccc({0})cc2)cc1",      # biphenyl
    "c1cc2cc({0})ccc2[nH]1",         # indole
)

SUBSTITUENTS: Tuple[str, ...] = (
    "", "C", "CC", "CCC", "C(C)C", "C(C)(C)C",
    "O", "OC", "OCC", "OC(C)C",
    "N", "NC", "N(C)C", "NC(=O)C",
    "F", "Cl", "Br", "I", "C(F)(F)F",
    "C#N", "C=C", "C#C",
    "C(=O)O", "C(=O)OC", "C(=O)N", "C(=O)NC",
    "S(=O)(=O)N", "SC", "[N+](=O)[O-]",
    "CO", "CCO", "CN", "CCN", "Cc9ccccc9", "Oc9ccccc9",  # digit 9: never collides with scaffold rings
)


# chain fragments a substituent may be extended through (free valence at
# the tail); terminals like F / C#N / nitro cannot be extended
LINKERS: Tuple[str, ...] = (
    "C", "CC", "CCC", "O", "OC", "N", "NC", "CO", "CN",
    "C(=O)", "C(=O)N", "S(=O)(=O)", "OCC", "NCC",
)


def _expand(scaffold: str, subs: List[str]) -> str:
    out = scaffold
    for i, s in enumerate(subs):
        out = out.replace("{%d}" % i, s)
    # empty substituent leaves "()" — strip it
    return out.replace("()", "")


def make_smiles_library(n: int, seed: int = 0, noise: float = 0.15,
                        p_linker: float = 0.6
                        ) -> Tuple[List[str], np.ndarray]:
    """``n`` drug-like SMILES + docking-like scores (lower = better).

    Scores follow an additive fragment-contribution model: every scaffold,
    linker and substituent draws a latent contribution once per library; a
    molecule's score is the sum over its fragments plus N(0, noise).
    Molecules sharing fragments therefore score similarly — the
    structure-activity coupling the traversal exploits, now carried by
    REAL shared substructures (which Morgan fingerprints detect) instead
    of shared characters. With probability ``p_linker`` a substituent is
    reached through a chain linker (scaffold-{linker}-substituent), which
    grows the combinatorial space to ~10^6 distinct structures.
    """
    rng = np.random.default_rng(seed)
    n_sites = [s.count("{") for s in SCAFFOLDS]
    scaf_e = rng.normal(0.0, 1.0, len(SCAFFOLDS))
    sub_e = rng.normal(0.0, 0.6, len(SUBSTITUENTS))
    link_e = rng.normal(0.0, 0.4, len(LINKERS))

    smiles: List[str] = []
    scores: List[float] = []
    seen = set()
    attempts = 0
    while len(smiles) < n and attempts < 50 * n:
        attempts += 1
        si = int(rng.integers(len(SCAFFOLDS)))
        subs, e = [], scaf_e[si]
        for _ in range(n_sites[si]):
            bi = int(rng.integers(len(SUBSTITUENTS)))
            base = SUBSTITUENTS[bi]
            e += sub_e[bi]
            if base and rng.random() < p_linker:
                li = int(rng.integers(len(LINKERS)))
                base = LINKERS[li] + base
                e += link_e[li]
                if rng.random() < 0.3:
                    lj = int(rng.integers(len(LINKERS)))
                    base = LINKERS[lj] + base
                    e += link_e[lj]
            subs.append(base)
        smi = _expand(SCAFFOLDS[si], subs)
        if smi in seen:
            continue
        seen.add(smi)
        smiles.append(smi)
        scores.append(e + rng.normal(0.0, noise))
    if len(smiles) < n:
        raise ValueError(
            f"combinatorial space exhausted at {len(smiles)} unique "
            f"molecules (requested {n})")
    return smiles, np.asarray(scores)
