"""Dependency-free chemistry: SMILES parser + Morgan/ECFP fingerprints.

The real-chemistry validation path: fingerprints
must be structural (SMILES-writing-order invariant), chemically sane
(similar structures -> high Tanimoto), and batch-packable into the
library build format.
"""

import numpy as np
import pytest

from rad_tpu.chem import (morgan_fingerprint, morgan_fingerprints_packed,
                          parse_smiles)
from rad_tpu.chem.library import make_smiles_library
from rad_tpu.chem.morgan import SmilesError


def test_parse_basic_molecules():
    m = parse_smiles("CCO")  # ethanol
    assert m.n_atoms == 3 and len(m.bonds) == 2
    assert [a.h_count for a in m.atoms] == [3, 2, 1]

    benzene = parse_smiles("c1ccccc1")
    assert benzene.n_atoms == 6 and len(benzene.bonds) == 6
    assert all(a.aromatic and a.in_ring and a.h_count == 1
               for a in benzene.atoms)

    aspirin = parse_smiles("CC(=O)Oc1ccccc1C(=O)O")
    assert aspirin.n_atoms == 13 and len(aspirin.bonds) == 13

    pyridine = parse_smiles("c1ccncc1")
    n_atom = next(a for a in pyridine.atoms if a.element == "N")
    assert n_atom.h_count == 0

    charged = parse_smiles("[N+](=O)[O-]")
    assert charged.atoms[0].charge == 1
    assert charged.atoms[2].charge == -1


def test_parse_errors():
    for bad in ("C(", "C)", "C1CC", "[Xx]", "C%1", ""):
        with pytest.raises(SmilesError):
            parse_smiles(bad)


def test_ring_perception():
    # all cyclohexane atoms in-ring, regardless of closure placement
    for smi in ("C1CCCCC1", "C2CCCCC2"):
        assert all(a.in_ring for a in parse_smiles(smi).atoms)
    # toluene: methyl carbon is NOT in a ring
    tol = parse_smiles("Cc1ccccc1")
    assert not tol.atoms[0].in_ring
    assert all(a.in_ring for a in tol.atoms[1:])
    # diphenylmethane: the CH2 bridge is NOT in a ring
    dpm = parse_smiles("c1ccccc1Cc1ccccc1")
    bridge = dpm.atoms[6]
    assert bridge.element == "C" and not bridge.in_ring


@pytest.mark.parametrize("a,b", [
    ("c1ccccc1C(=O)O", "OC(=O)c1ccccc1"),
    ("CC(=O)Oc1ccccc1C(=O)O", "OC(=O)c1ccccc1OC(C)=O"),
    ("C1CCCCC1", "C2CCCCC2"),
    ("CCO", "OCC"),
    ("c1ccc2ccccc2c1", "c1ccc2c(c1)cccc2"),
    ("CC(N)C(=O)O", "OC(=O)C(C)N"),
])
def test_fingerprint_writing_order_invariant(a, b):
    np.testing.assert_array_equal(morgan_fingerprint(a),
                                  morgan_fingerprint(b))


def test_similarity_is_chemical():
    def tan(x, y):
        fx, fy = morgan_fingerprint(x), morgan_fingerprint(y)
        return int((fx & fy).sum()) / int((fx | fy).sum())

    # homologous series closer than unrelated structures
    assert tan("CCO", "CCCO") > tan("CCO", "c1ccccc1")
    assert tan("CC(=O)Oc1ccccc1C(=O)O", "OC(=O)c1ccccc1O") > 0.3
    # identical molecule -> identical fingerprint
    assert tan("c1ccncc1", "c1ccncc1") == 1.0


def test_radius_and_bits():
    fp0 = morgan_fingerprint("CCO", radius=0)
    fp2 = morgan_fingerprint("CCO", radius=2)
    assert fp2.sum() > fp0.sum()
    fp_small = morgan_fingerprint("CC(=O)Oc1ccccc1C(=O)O", n_bits=256)
    assert fp_small.shape == (256,)
    assert fp_small.sum() > 0


def test_library_generates_unique_parseable_molecules():
    smiles, scores = make_smiles_library(3000, seed=4)
    assert len(smiles) == len(set(smiles)) == 3000
    assert np.isfinite(scores).all()
    for s in smiles[:300]:
        parse_smiles(s)


def test_library_scores_follow_structure():
    """Additive SAR: molecules sharing a scaffold correlate in score more
    than random pairs (the coupling the traversal exploits)."""
    smiles, scores = make_smiles_library(3000, seed=4)
    from rad_tpu.chem.library import SCAFFOLDS
    # group by scaffold prefix (first 8 chars is scaffold-determined)
    groups = {}
    for s, sc in zip(smiles, scores):
        groups.setdefault(s[:8], []).append(sc)
    within = np.mean([np.var(v) for v in groups.values() if len(v) > 10])
    total = np.var(scores)
    assert within < total, (within, total)


def test_packed_batch():
    smiles, _ = make_smiles_library(64, seed=1)
    packed = morgan_fingerprints_packed(smiles, n_bits=512)
    assert packed.shape == (64, 16)
    assert packed.dtype == np.uint32
    # non-degenerate: distinct molecules mostly distinct fingerprints
    uniq = len({p.tobytes() for p in packed})
    assert uniq > 55


# ---------------------------------------------------------------------------
# Golden ECFP invariants: the exact Rogers & Hahn 2010 §2
# invariant tuples feeding the hash, hand-computed for known molecules. This
# is the executable specification standing in for an RDKit bit-for-bit
# comparison (impossible in this offline container): if these tuples are
# right, the information content entering the fingerprint matches ECFP's.
# Tuple layout (rad_tpu.chem.initial_invariant_tuples): (heavy-atom degree,
# heavy valence, atomic number, charge & 0xFF, attached H count, in-ring,
# aromatic). Aromatic bonds count 1 toward heavy valence.
# ---------------------------------------------------------------------------

from rad_tpu.chem import initial_invariant_tuples

_C_AROM = (2, 2, 6, 0, 1, 1, 1)          # unsubstituted aromatic CH

GOLDEN_INVARIANTS = [
    ("methane", "C", [(0, 0, 6, 0, 4, 0, 0)]),
    ("water", "O", [(0, 0, 8, 0, 2, 0, 0)]),
    ("ethanol", "CCO", [(1, 1, 6, 0, 3, 0, 0),
                        (2, 2, 6, 0, 2, 0, 0),
                        (1, 1, 8, 0, 1, 0, 0)]),
    ("ethene", "C=C", [(1, 2, 6, 0, 2, 0, 0)] * 2),
    ("acetylene", "C#C", [(1, 3, 6, 0, 1, 0, 0)] * 2),
    ("benzene", "c1ccccc1", [_C_AROM] * 6),
    ("pyridine", "c1ccncc1", [_C_AROM, _C_AROM, _C_AROM,
                              (2, 2, 7, 0, 0, 1, 1),  # aromatic N, no H
                              _C_AROM, _C_AROM]),
    ("phenol", "Oc1ccccc1", [(1, 1, 8, 0, 1, 0, 0),
                             (3, 3, 6, 0, 0, 1, 1),  # ipso carbon
                             _C_AROM, _C_AROM, _C_AROM, _C_AROM, _C_AROM]),
    ("acetic acid", "CC(=O)O", [(1, 1, 6, 0, 3, 0, 0),
                                (3, 4, 6, 0, 0, 0, 0),  # carboxyl C
                                (1, 2, 8, 0, 0, 0, 0),  # carbonyl O
                                (1, 1, 8, 0, 1, 0, 0)]),  # hydroxyl O
    ("ammonium", "[NH4+]", [(0, 0, 7, 1, 4, 0, 0)]),
    ("acetate anion", "CC(=O)[O-]", [(1, 1, 6, 0, 3, 0, 0),
                                     (3, 4, 6, 0, 0, 0, 0),
                                     (1, 2, 8, 0, 0, 0, 0),
                                     (1, 1, 8, 255, 0, 0, 0)]),
    ("cyclohexane", "C1CCCCC1", [(2, 2, 6, 0, 2, 1, 0)] * 6),
    ("thiophene S", "c1ccsc1", None),  # spot-check S below
]


def test_golden_invariants():
    for name, smi, expected in GOLDEN_INVARIANTS:
        if expected is None:
            continue
        got = initial_invariant_tuples(parse_smiles(smi))
        assert got == expected, f"{name}: {got} != {expected}"


def test_golden_invariants_heteroaromatics():
    # aromatic S keeps its lowest valence class: no H on thiophene S
    thio = initial_invariant_tuples(parse_smiles("c1ccsc1"))
    assert thio[3] == (2, 2, 16, 0, 0, 1, 1)
    # pyrrole-type N carries its H; written form requires [nH]
    pyrrole = initial_invariant_tuples(parse_smiles("c1cc[nH]c1"))
    assert pyrrole[3] == (2, 2, 7, 0, 1, 1, 1)
    furan = initial_invariant_tuples(parse_smiles("c1ccoc1"))
    assert furan[3] == (2, 2, 8, 0, 0, 1, 1)


def test_golden_distinct_environment_counts():
    """ECFP bit counts == number of distinct circular environments, derived
    by hand. Pyridine: round 0 has {C, N} = 2; round 1 adds {N(cc), C2/C6
    (Nc), C3/C5/C4 (cc)} = 3; round 2 splits C3/C5 from C4 = 4. Benzene:
    one environment per round. Ethanol r2 environments dedup against r1
    (the whole molecule was already seen as C2's r1 environment)."""
    cases = [
        ("c1ccccc1", [1, 2, 3]),
        ("c1ccncc1", [2, 5, 9]),
        ("CCO", [3, 6, 6]),
        ("C", [1, 1, 1]),  # no neighbors: no new environments after r0
    ]
    for smi, counts in cases:
        for r, want in enumerate(counts):
            got = int(morgan_fingerprint(smi, radius=r).sum())
            assert got == want, (smi, r, got, want)


KEKULE_PAIRS = [
    ("benzene", "c1ccccc1", "C1=CC=CC=C1"),
    ("pyridine", "c1ccncc1", "C1=CC=NC=C1"),
    ("pyrrole", "c1cc[nH]c1", "C1=CC=CN1"),
    ("furan", "c1ccoc1", "C1=CC=CO1"),
    ("thiophene", "c1ccsc1", "C1=CC=CS1"),
    ("imidazole", "c1c[nH]cn1", "C1=CN=CN1"),
    ("naphthalene", "c1ccc2ccccc2c1", "C1=CC=C2C=CC=CC2=C1"),
    ("toluene", "Cc1ccccc1", "CC1=CC=CC=C1"),
    ("benzothiophene", "c1ccc2sccc2c1", "C1=CC=C2SC=CC2=C1"),
    ("styrene", "C=Cc1ccccc1", "C=CC1=CC=CC=C1"),
]


def test_kekulized_equals_aromatic():
    """Aromatic-written and kekulized SMILES of the same ring system must
    fingerprint identically (RDKit re-perceives aromaticity;
    item 7 asks for the same invariance here)."""
    for name, arom, kek in KEKULE_PAIRS:
        fa, fk = morgan_fingerprint(arom), morgan_fingerprint(kek)
        np.testing.assert_array_equal(fa, fk, err_msg=name)


def test_antiaromatic_and_saturated_not_perceived():
    for smi in ["C1=CC=CCC1",        # cyclohexadiene: sp3 carbons
                "O=C1C=CC(=O)C=C1",  # quinone: exocyclic C=O, 4 pi
                "C1CCCCC1",          # cyclohexane
                "C1=CC=C1"]:         # cyclobutadiene: 4n
        m = parse_smiles(smi)
        assert not any(a.aromatic for a in m.atoms), smi


def test_cross_conjugated_exocyclic_doubles_not_aromatic():
    """A double bond into an UNRELATED (non-fused) ring must not count
    toward the pi system (ADVICE r4: the old in-any-ring rule falsely
    aromatized quinodimethane-type cross-conjugation when the exocyclic
    partners happened to sit in other rings)."""
    # benzoquinodimethane core with both exocyclic doubles landing on
    # cyclohexylidene ring atoms: old rule counted 4+2=6 pi -> aromatic
    smi = "C1=CC(=C2CCCCC2)C(=C2CCCCC2)C=C1"
    m = parse_smiles(smi)
    assert not any(a.aromatic for a in m.atoms), smi
    # pentafulvalene: two cross-conjugated cyclopentadienylidene rings
    m2 = parse_smiles("C1=CC(C=C1)=C1C=CC=C1")
    assert not any(a.aromatic for a in m2.atoms)


def test_alternate_kekule_forms_agree():
    """Every Kekulé structure of a fused aromatic must fingerprint like
    the aromatic-written form — including forms whose fusion atoms are
    double-bonded into the sibling ring (the fused-ring pi-count rule)
    and forms needing the Hückel fixpoint iteration (ADVICE r4)."""
    ref = morgan_fingerprint("c1ccc2ccccc2c1")
    for kek in ["C1=CC=C2C=CC=CC2=C1",   # fusion bond double
                "C1=CC2=CC=CC=C2C=C1"]:  # fusion atoms double into rings
        np.testing.assert_array_equal(
            ref, morgan_fingerprint(kek), err_msg=kek)
    # anthracene: middle ring's qualification depends on outer rings
    ref3 = morgan_fingerprint("c1ccc2cc3ccccc3cc2c1")
    kek3 = morgan_fingerprint("C1=CC=C2C=C3C=CC=CC3=CC2=C1")
    np.testing.assert_array_equal(ref3, kek3)
