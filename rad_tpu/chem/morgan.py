"""SMILES parser + Morgan (ECFP) circular fingerprints, no dependencies.

Replaces the character-n-gram proxy fingerprinter for the real-chemistry
validation path. The reference pipeline is RDKit
``GetMorganFingerprintAsBitVect(mol, 2, 1024)`` + ``np.packbits``
(/root/reference/examples/DUDEZ_example.ipynb:92-118); this module
implements the same algorithm family from the primary sources:

* SMILES grammar: the OpenSMILES specification subset that covers
  drug-like molecules — organic-subset atoms, bracket atoms with charge/
  isotope/explicit H, aromatic lowercase forms, branches, ring-closure
  digits (incl. ``%nn``), bond symbols ``- = # : / \\`` and dot
  disconnects. Kekulized ring systems are aromatized by a Hückel 4n+2
  perception pass over 5-7-membered rings (:func:`_perceive_aromaticity`),
  so ``C1=CC=CC=C1`` and ``c1ccccc1`` produce identical fingerprints
  (pinned by tests/test_chem.py golden/kekulized cases).
* ECFP (Rogers & Hahn 2010): per-atom initial invariants (heavy-atom
  degree, non-H valence, atomic number, charge, attached H count,
  in-ring flag), then ``radius`` rounds of neighborhood hashing over
  sorted (bond-order, neighbor-identifier) pairs; every intermediate
  identifier folds into the ``n_bits`` bitvector.

Hash values are a deterministic 32-bit mix (not RDKit's), so bit
POSITIONS differ from RDKit while the structural information content is
the same: fingerprints are invariant to the SMILES writing order
(pinned by tests/test_chem.py round-trip cases) and Tanimoto behaves as
a real 2D chemical similarity.

FINGERPRINT FORMAT VERSION: bit assignments are stable only within a
``FP_FORMAT_VERSION``. Perception/dedup changes bump it (v2: r4's
round-0-singleton seeding + kekulized aromatization; v3: r5's fused-ring
π counting + Hückel fixpoint). Indexes persisted under an older version
must be rebuilt before new query fingerprints can be matched against
them — compare the version stamped at build time with the current one.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["MolGraph", "parse_smiles", "morgan_fingerprint",
           "morgan_fingerprints_packed", "initial_invariant_tuples",
           "FP_FORMAT_VERSION"]

#: bump on ANY change to perception, invariants, hashing, or dedup — a
#: persisted index and a query fingerprinted under different versions
#: silently mismatch (tanimoto drops, recall collapses) instead of
#: erroring. Graph saves stamp this (graph/storage.py save metadata).
FP_FORMAT_VERSION = 3

_ORGANIC = {"B": 3, "C": 4, "N": 3, "O": 2, "P": 3, "S": 2,
            "F": 1, "Cl": 1, "Br": 1, "I": 1}
_AROMATIC_ORGANIC = {"b", "c", "n", "o", "p", "s"}
_ELEMENTS = {
    "H": 1, "He": 2, "Li": 3, "Be": 4, "B": 5, "C": 6, "N": 7, "O": 8,
    "F": 9, "Ne": 10, "Na": 11, "Mg": 12, "Al": 13, "Si": 14, "P": 15,
    "S": 16, "Cl": 17, "Ar": 18, "K": 19, "Ca": 20, "Ti": 22, "Cr": 24,
    "Mn": 25, "Fe": 26, "Co": 27, "Ni": 28, "Cu": 29, "Zn": 30, "As": 33,
    "Se": 34, "Br": 35, "Sr": 38, "Mo": 42, "Ru": 44, "Rh": 45, "Pd": 46,
    "Ag": 47, "Cd": 48, "Sn": 50, "Sb": 51, "Te": 52, "I": 53, "Ba": 56,
    "W": 74, "Pt": 78, "Au": 79, "Hg": 80, "Pb": 82, "Bi": 83,
}
# default valences for implicit-H assignment (OpenSMILES table)
_VALENCE = {"B": (3,), "C": (4,), "N": (3, 5), "O": (2,), "P": (3, 5),
            "S": (2, 4, 6), "F": (1,), "Cl": (1,), "Br": (1,), "I": (1,)}


@dataclasses.dataclass
class _Atom:
    element: str
    aromatic: bool
    charge: int = 0
    isotope: int = 0
    explicit_h: Optional[int] = None  # None = derive from valence
    in_ring: bool = False
    h_count: int = 0                  # resolved after parsing


@dataclasses.dataclass
class MolGraph:
    """Molecular graph: atoms + bonds (order 1/2/3; 1.5 = aromatic)."""
    atoms: List[_Atom]
    bonds: List[Tuple[int, int, float]]

    @property
    def n_atoms(self) -> int:
        return len(self.atoms)

    def neighbors(self, i: int) -> List[Tuple[int, float]]:
        out = []
        for a, b, o in self.bonds:
            if a == i:
                out.append((b, o))
            elif b == i:
                out.append((a, o))
        return out


class SmilesError(ValueError):
    pass


def _bond_order(sym: str, a_arom: bool, b_arom: bool) -> float:
    if sym == "=":
        return 2.0
    if sym == "#":
        return 3.0
    if sym == ":":
        return 1.5
    if sym in ("-", "/", "\\"):
        return 1.0
    # default bond: aromatic between two aromatic atoms, else single
    return 1.5 if (a_arom and b_arom) else 1.0


def parse_smiles(smiles: str) -> MolGraph:
    """Parse a SMILES string into a :class:`MolGraph`.

    Raises :class:`SmilesError` on malformed input (unbalanced brackets,
    dangling ring closures, unknown elements).
    """
    atoms: List[_Atom] = []
    bonds: List[Tuple[int, int, float]] = []
    stack: List[int] = []
    ring: dict = {}          # closure digit -> (atom_idx, bond_sym)
    prev = -1
    pending_bond = ""
    i, n = 0, len(smiles)

    def add_atom(atom: _Atom) -> None:
        nonlocal prev, pending_bond
        idx = len(atoms)
        atoms.append(atom)
        if prev >= 0 and pending_bond != ".":
            order = _bond_order(pending_bond, atoms[prev].aromatic,
                                atom.aromatic)
            bonds.append((prev, idx, order))
        prev = idx
        pending_bond = ""

    while i < n:
        c = smiles[i]
        if c in "-=#:/\\.":
            pending_bond = c
            i += 1
        elif c == "(":
            if prev < 0:
                raise SmilesError("branch before any atom")
            stack.append(prev)
            i += 1
        elif c == ")":
            if not stack:
                raise SmilesError("unbalanced ')'")
            prev = stack.pop()
            i += 1
        elif c.isdigit() or c == "%":
            if c == "%":
                if i + 2 >= n or not smiles[i + 1: i + 3].isdigit():
                    raise SmilesError("bad %nn ring closure")
                num = int(smiles[i + 1: i + 3])
                i += 3
            else:
                num = int(c)
                i += 1
            if prev < 0:
                raise SmilesError("ring closure before any atom")
            if num in ring:
                j, sym = ring.pop(num)
                if j == prev:
                    raise SmilesError("self ring closure")
                sym = sym or pending_bond
                order = _bond_order(sym, atoms[j].aromatic,
                                    atoms[prev].aromatic)
                bonds.append((j, prev, order))
                atoms[j].in_ring = True
                atoms[prev].in_ring = True
            else:
                ring[num] = (prev, pending_bond)
            pending_bond = ""
        elif c == "[":
            j = smiles.find("]", i)
            if j < 0:
                raise SmilesError("unbalanced '['")
            add_atom(_parse_bracket(smiles[i + 1: j]))
            i = j + 1
        elif c.isalpha():
            # two-letter organic subset first (Cl, Br)
            two = smiles[i: i + 2]
            if two in ("Cl", "Br"):
                add_atom(_Atom(two, aromatic=False))
                i += 2
            elif c in _ORGANIC:
                add_atom(_Atom(c, aromatic=False))
                i += 1
            elif c in _AROMATIC_ORGANIC:
                add_atom(_Atom(c.upper(), aromatic=True))
                i += 1
            else:
                raise SmilesError(f"unknown atom {c!r} at {i}")
        else:
            raise SmilesError(f"unexpected char {c!r} at {i}")

    if stack:
        raise SmilesError("unbalanced '('")
    if ring:
        raise SmilesError(f"dangling ring closures: {sorted(ring)}")
    if not atoms:
        raise SmilesError("empty SMILES")

    mol = MolGraph(atoms, bonds)
    ring_edges = _mark_rings(mol)
    _assign_hydrogens(mol)
    _perceive_aromaticity(mol, ring_edges)
    return mol


def _mark_rings(mol: MolGraph) -> set:
    """Exact ring membership: an atom is in a ring iff it touches a
    non-bridge edge (Tarjan bridge finding, iterative DFS). Ring-closure
    bonds alone under-mark (only the closure pair), which would make
    invariants depend on how the SMILES was written.

    Returns the set of ring (non-bridge) bond indices — tree edges with
    ``low[child] <= disc[parent]`` plus every back edge — consumed by the
    aromaticity perception pass."""
    n = mol.n_atoms
    adj: List[List[Tuple[int, int]]] = [[] for _ in range(n)]
    for ei, (a, b, _) in enumerate(mol.bonds):
        adj[a].append((b, ei))
        adj[b].append((a, ei))
    disc = [-1] * n
    low = [0] * n
    in_ring = [False] * n
    ring_edges: set = set()
    timer = 0
    for root in range(n):
        if disc[root] >= 0:
            continue
        stack = [(root, -1, iter(adj[root]))]
        disc[root] = low[root] = timer
        timer += 1
        while stack:
            u, pe, it = stack[-1]
            advanced = False
            for v, ei in it:
                if ei == pe:
                    continue
                if disc[v] < 0:
                    disc[v] = low[v] = timer
                    timer += 1
                    stack.append((v, ei, iter(adj[v])))
                    advanced = True
                    break
                low[u] = min(low[u], disc[v])
                ring_edges.add(ei)  # back edge: always on a cycle
            if advanced:
                continue
            stack.pop()
            if stack:
                p = stack[-1][0]
                low[p] = min(low[p], low[u])
                if low[u] <= disc[p]:
                    # edge (p, u) is in a cycle (not a bridge)
                    in_ring[p] = True
                    in_ring[u] = True
                    ring_edges.add(pe)
    for i, a in enumerate(mol.atoms):
        a.in_ring = in_ring[i]
    return ring_edges


def _small_rings(mol: MolGraph, ring_edges: set) -> List[frozenset]:
    """Smallest rings (SSSR-style): for each ring bond, the shortest cycle
    through it found by BFS over ring bonds only; deduplicated."""
    n = mol.n_atoms
    adj: List[List[Tuple[int, int]]] = [[] for _ in range(n)]
    for ei in ring_edges:
        a, b, _ = mol.bonds[ei]
        adj[a].append((b, ei))
        adj[b].append((a, ei))
    rings = []
    seen = set()
    for ei in ring_edges:
        a, b, _ = mol.bonds[ei]
        # BFS a -> b avoiding edge ei
        parent = {a: (-1, -1)}
        frontier = [a]
        found = False
        while frontier and not found:
            nxt = []
            for u in frontier:
                for v, ej in adj[u]:
                    if ej == ei or v in parent:
                        continue
                    parent[v] = (u, ej)
                    if v == b:
                        found = True
                        break
                    nxt.append(v)
                if found:
                    break
            frontier = nxt
        if not found:
            continue
        path = [b]
        u = b
        while u != a:
            u = parent[u][0]
            path.append(u)
        ring = frozenset(path)
        if ring not in seen:
            seen.add(ring)
            rings.append(ring)
    return rings


def _perceive_aromaticity(mol: MolGraph, ring_edges: set) -> None:
    """Hückel 4n+2 aromatization of kekulized rings, so aromatic-written
    and kekulized SMILES of the same ring system fingerprint identically
    (RDKit re-perceives aromaticity the same way; the reference pipeline
    therefore never sees kekulized forms downstream).

    Per 5-7-membered smallest ring, each atom contributes to the π count:
    1 for a double bond whose partner is a ring atom (in-ring or fused),
    2 for a lone pair on an otherwise-saturated N/O/S/Se/P (pyrrole-type)
    or a carbanion, 0 for a carbocation or an exocyclic double bond to a
    non-ring atom (quinones stay non-aromatic). A saturated neutral carbon
    or any triple bond disqualifies the ring. Qualifying rings have their
    in-ring bonds set to order 1.5, atoms flagged aromatic, and H counts
    frozen from the kekulized structure (pyrrole-type N keeps its H)."""
    if not ring_edges:
        return
    rings = [r for r in _small_rings(mol, ring_edges) if 5 <= len(r) <= 7]
    if not rings:
        return
    bond_of = {}
    for ei, (a, b, o) in enumerate(mol.bonds):
        bond_of[(a, b)] = ei
        bond_of[(b, a)] = ei

    nbrs: List[List[Tuple[int, float]]] = [[] for _ in range(mol.n_atoms)]
    for a, b, o in mol.bonds:
        nbrs[a].append((b, o))
        nbrs[b].append((a, o))

    def pi_contribution(idx: int, ring: frozenset,
                        fused_atoms: frozenset) -> Optional[int]:
        atom = mol.atoms[idx]
        doubles = [j for j, o in nbrs[idx] if o == 2.0]
        if any(o == 3.0 for _, o in nbrs[idx]):
            return None
        if atom.aromatic:
            return 1  # already-aromatic fused neighbor ring
        if doubles:
            # a double counts toward this ring's π system only if its
            # partner is IN the ring, already aromatic, or an atom of a
            # ring edge-fused to this one (the kekulized-naphthalene
            # fusion atom whose double points into the sibling ring).
            # A double to an atom of an UNRELATED ring is exocyclic
            # cross-conjugation (fulvalene/quinone-methide) and counts 0
            # — matching RDKit perception.
            if any(j in ring or mol.atoms[j].aromatic or j in fused_atoms
                   for j in doubles):
                return 1
            return 0  # exocyclic C=O / cross-conjugated C=C etc.
        if atom.element in ("N", "O", "S", "Se", "P"):
            return 2  # lone pair (pyrrole/furan/thiophene-type)
        if atom.element == "C":
            if atom.charge < 0:
                return 2
            if atom.charge > 0:
                return 0
            return None  # saturated neutral carbon breaks conjugation
        return None

    # union of atoms in rings edge-fused (>=2 shared atoms) to each ring
    fused_of = []
    for ring in rings:
        f = set()
        for other in rings:
            if other is not ring and len(other & ring) >= 2:
                f |= other
        fused_of.append(frozenset(f - ring))

    # iterate the per-ring Hückel pass to a fixpoint: a ring that only
    # qualifies once a fused neighbor has aromatized (via the
    # atom.aromatic contribution) must not depend on processing order
    changed = True
    while changed:
        changed = False
        for ring, fused_atoms in zip(rings, fused_of):
            if all(mol.atoms[i].aromatic for i in ring):
                continue  # written aromatic already (or done last pass)
            total = 0
            ok = True
            for idx in ring:
                c = pi_contribution(idx, ring, fused_atoms)
                if c is None:
                    ok = False
                    break
                total += c
            if not ok or total not in (2, 6, 10, 14):
                continue
            changed = True
            for idx in ring:
                atom = mol.atoms[idx]
                # freeze the kekulized H count before flipping flags: the
                # aromatic-H rule must not re-derive (pyrrole N keeps its H)
                atom.explicit_h = atom.h_count
                atom.aromatic = True
            for idx in ring:
                for j, _o in nbrs[idx]:
                    if j in ring:
                        ei = bond_of[(idx, j)]
                        a, b, _ = mol.bonds[ei]
                        mol.bonds[ei] = (a, b, 1.5)


def _parse_bracket(body: str) -> _Atom:
    """``[isotope? element chiral? Hcount? charge?]`` (chirality ignored —
    2D fingerprints are achiral, as is RDKit's default Morgan)."""
    i, n = 0, len(body)
    isotope = 0
    while i < n and body[i].isdigit():
        isotope = isotope * 10 + int(body[i])
        i += 1
    aromatic = False
    if i < n and body[i].islower() and body[i] in _AROMATIC_ORGANIC | {"se"}:
        # aromatic bracket atom (c, n, o, s, se, p, ...)
        if body[i: i + 2] == "se":
            elem, i, aromatic = "Se", i + 2, True
        else:
            elem, i, aromatic = body[i].upper(), i + 1, True
    else:
        if i + 1 < n and body[i: i + 2] in _ELEMENTS and body[i + 1].islower():
            elem, i = body[i: i + 2], i + 2
        elif i < n and body[i] in _ELEMENTS:
            elem, i = body[i], i + 1
        else:
            raise SmilesError(f"bad bracket atom [{body}]")
    while i < n and body[i] in "@":
        i += 1
        if i < n and body[i] == "@":
            i += 1
    h = 0
    if i < n and body[i] == "H":
        i += 1
        h = 1
        if i < n and body[i].isdigit():
            h = int(body[i])
            i += 1
    charge = 0
    while i < n and body[i] in "+-":
        sign = 1 if body[i] == "+" else -1
        i += 1
        if i < n and body[i].isdigit():
            charge += sign * int(body[i])
            i += 1
        else:
            charge += sign
    if i != n:
        raise SmilesError(f"trailing junk in [{body}]")
    return _Atom(elem, aromatic=aromatic, charge=charge, isotope=isotope,
                 explicit_h=h)


def _assign_hydrogens(mol: MolGraph) -> None:
    """Implicit-H resolution per the OpenSMILES default-valence rule;
    bracket atoms use their explicit H count verbatim."""
    degree_order = [0.0] * mol.n_atoms
    for a, b, o in mol.bonds:
        eff = 1.0 if o == 1.5 else o
        degree_order[a] += eff
        degree_order[b] += eff
    for idx, atom in enumerate(mol.atoms):
        if atom.explicit_h is not None:
            atom.h_count = atom.explicit_h
            continue
        vals = _VALENCE.get(atom.element)
        if vals is None:
            atom.h_count = 0
            continue
        used = degree_order[idx]
        if atom.aromatic:
            # one valence slot is consumed by the aromatic system; and an
            # aromatic atom stays in its LOWEST valence class (aromatic S
            # in thiophene has 0 H — it must not be promoted to S(IV))
            used = max(used, sum(
                1 for a, b, o in mol.bonds if idx in (a, b)) + 1)
            atom.h_count = max(int(vals[0] - used), 0)
            continue
        h = 0
        for v in vals:
            if v >= used:
                h = int(v - used)
                break
        atom.h_count = max(h, 0)


# ------------------------------------------------------------------ ECFP

def _mix(*vals: int) -> int:
    """Deterministic 32-bit hash combine (FNV-style mixer)."""
    h = 0x811C9DC5
    for v in vals:
        h ^= v & 0xFFFFFFFF
        h = (h * 0x01000193) & 0xFFFFFFFF
        h ^= h >> 15
    return h


def initial_invariant_tuples(mol: MolGraph) -> List[Tuple[int, ...]]:
    """The raw per-atom ECFP round-0 invariant tuples feeding the hash —
    the Rogers & Hahn 2010 §2 list (heavy-atom degree, heavy valence,
    atomic number, charge, attached H count, in-ring flag) plus an
    aromaticity flag. Exposed so tests can pin hand-computed golden values
    for known molecules (tests/test_chem.py::test_golden_invariants)
    without depending on the hash mix."""
    nbrs = [[] for _ in range(mol.n_atoms)]
    for a, b, o in mol.bonds:
        nbrs[a].append(o)
        nbrs[b].append(o)
    out = []
    for idx, atom in enumerate(mol.atoms):
        heavy_deg = len(nbrs[idx])
        valence = int(sum(2 if o == 2 else 3 if o == 3 else 1
                          for o in nbrs[idx]))
        out.append((
            heavy_deg,
            valence,
            _ELEMENTS.get(atom.element, 0),
            atom.charge & 0xFF,
            atom.h_count,
            1 if atom.in_ring else 0,
            1 if atom.aromatic else 0,
        ))
    return out


def _initial_invariants(mol: MolGraph) -> List[int]:
    return [_mix(*t) for t in initial_invariant_tuples(mol)]


def morgan_fingerprint(smiles_or_mol, radius: int = 2,
                       n_bits: int = 1024) -> np.ndarray:
    """ECFP_{2*radius} folded bitvector (uint8 0/1 array of ``n_bits``).

    The reference protocol's r=2/1024 default matches
    examples/DUDEZ_example.ipynb:92-93.
    """
    mol = (smiles_or_mol if isinstance(smiles_or_mol, MolGraph)
           else parse_smiles(smiles_or_mol))
    nbrs = [[] for _ in range(mol.n_atoms)]
    for a, b, o in mol.bonds:
        ob = int(o * 2)  # 2, 3, 4, 6 for aromatic/single/... (1.5 -> 3)
        nbrs[a].append((b, ob))
        nbrs[b].append((a, ob))

    ids = _initial_invariants(mol)
    fp = np.zeros((n_bits,), np.uint8)
    # round-0 identifiers are part of the fingerprint (ECFP collects every
    # iteration's identifiers, Rogers & Hahn §2)
    for v in ids:
        fp[v % n_bits] = 1
    # substructure dedup: two identifiers describing the same circular
    # substructure (atom-set environment) contribute once — RDKit dedups
    # by bond set the same way. Seeding with the round-0 singletons stops
    # neighbor-less atoms (methane) emitting fresh ids every round.
    env = [frozenset([i]) for i in range(mol.n_atoms)]
    seen_env = set(env)

    for r in range(1, radius + 1):
        new_ids = []
        new_env = []
        for idx in range(mol.n_atoms):
            pairs = sorted((ob, ids[j]) for j, ob in nbrs[idx])
            flat = [r, ids[idx]]
            for ob, nid in pairs:
                flat += [ob, nid]
            new_ids.append(_mix(*flat))
            e = env[idx]
            for j, _ in nbrs[idx]:
                e = e | env[j]
            new_env.append(e)
        ids, env = new_ids, new_env
        # dedup identical substructures: one bit per distinct environment,
        # chosen as the MINIMUM identifier so the choice is invariant to
        # the SMILES atom-writing order
        best: dict = {}
        for idx, v in enumerate(ids):
            key = env[idx]
            if key not in best or v < best[key]:
                best[key] = v
        for key, v in best.items():
            if key in seen_env:
                continue
            seen_env.add(key)
            fp[v % n_bits] = 1
    return fp


def morgan_fingerprints_packed(smiles_list, radius: int = 2,
                               n_bits: int = 1024) -> np.ndarray:
    """Batch ``[N, n_bits/32] uint32`` packed fingerprints (the library
    build format, rad_tpu.fp.pack layout)."""
    from rad_tpu.fp.pack import pack_fingerprints

    bits = np.zeros((len(smiles_list), n_bits), np.uint8)
    for i, smi in enumerate(smiles_list):
        bits[i] = morgan_fingerprint(smi, radius=radius, n_bits=n_bits)
    return pack_fingerprints(bits)
