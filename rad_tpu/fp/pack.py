"""Bit-packing of binary molecular fingerprints into uint32 words.

Layout: bit ``j`` of a ``d``-bit fingerprint lives in word ``j // 32`` at bit
position ``j % 32`` (LSB-first). A fingerprint matrix is ``[N, W] uint32``
with ``W = ceil(d / 32)`` — for the reference's canonical 1024-bit Morgan
fingerprints (reference: examples/DUDEZ_example.ipynb:92-118) that is 32 words
= 128 bytes per molecule, identical to usearch's b1 storage density.

:func:`popcount` implements the SWAR add-shift-mask reduction on uint32
with plain integer ops, so it runs on every backend.
"""

from __future__ import annotations


from typing import Iterable, Sequence

import jax.numpy as jnp
import numpy as np

__all__ = [
    "pack_fingerprints",
    "unpack_fingerprints",
    "popcount",
    "popcount_rows",
    "random_fingerprints",
    "smiles_fingerprint",
    "smiles_fingerprints",
]

_M1 = 0x55555555
_M2 = 0x33333333
_M4 = 0x0F0F0F0F
_H01 = 0x01010101


def packed_words(n_bits: int) -> int:
    """Number of uint32 words needed for an ``n_bits``-bit fingerprint."""
    return (n_bits + 31) // 32


def pack_fingerprints(bits: np.ndarray) -> np.ndarray:
    """Pack a ``[N, d]`` 0/1 matrix into ``[N, ceil(d/32)] uint32`` (LSB-first).

    Layout: bit ``j`` → word ``j // 32``, bit position ``j % 32``. With
    little-endian words this equals ``np.packbits(bitorder='little')``
    reinterpreted as uint32, which is what the fast path does.
    """
    bits = np.asarray(bits)
    if bits.ndim == 1:
        return pack_fingerprints(bits[None, :])[0]
    n, d = bits.shape
    w = packed_words(d)
    if d % 32:
        padded = np.zeros((n, w * 32), dtype=np.uint8)
        padded[:, :d] = bits.astype(np.uint8) & 1
        bits = padded
    else:
        bits = np.ascontiguousarray(bits.astype(np.uint8) & 1)
    packed_bytes = np.packbits(bits, axis=1, bitorder="little")
    words = packed_bytes.view("<u4")
    if words.dtype != np.uint32 or not words.flags.c_contiguous:
        words = words.astype(np.uint32)
    return np.ascontiguousarray(words)


def coerce_packed(vectors: np.ndarray, n_bits: int) -> np.ndarray:
    """Normalize any supported fingerprint layout to ``[N, W] uint32``.

    Accepts the three layouts users actually hold (reference usage,
    README.md:58-63 — usearch ``b1`` indices are fed ``np.packbits``
    output):

    - ``[N, n_bits/32] uint32`` — this package's packed layout (passthrough);
    - ``[N, n_bits]`` 0/1 bits (any integer/bool dtype) — auto-packed;
    - ``[N, n_bits/8] uint8`` — ``np.packbits(bitorder='big')`` rows, the
      layout every reference/usearch pipeline already has on disk.

    1-D inputs are treated as a single fingerprint. Raises ``ValueError``
    for anything else.
    """
    vectors = np.asarray(vectors)
    if vectors.ndim == 1:
        return coerce_packed(vectors[None, :], n_bits)
    if vectors.ndim != 2:
        raise ValueError(f"expected a 2-D fingerprint array, got shape "
                         f"{vectors.shape}")
    w = packed_words(n_bits)
    cols = vectors.shape[1]
    if cols == w and vectors.dtype in (np.dtype(np.uint32),
                                       np.dtype(np.int32),
                                       np.dtype(np.uint64),
                                       np.dtype(np.int64)):
        return np.ascontiguousarray(vectors.astype(np.uint32, copy=False))
    if cols == n_bits:
        return pack_fingerprints(vectors)
    if cols == (n_bits + 7) // 8 and vectors.dtype == np.uint8:
        bits = np.unpackbits(vectors, axis=1, bitorder="big")[:, :n_bits]
        return pack_fingerprints(bits)
    raise ValueError(
        f"expected packed [N, {w}] uint32, [N, {n_bits}] bits, or "
        f"np.packbits [N, {(n_bits + 7) // 8}] uint8 rows; got shape "
        f"{vectors.shape} dtype {vectors.dtype}")


def unpack_fingerprints(packed: np.ndarray, n_bits: int | None = None) -> np.ndarray:
    """Unpack ``[N, W] uint32`` back to a ``[N, n_bits]`` uint8 0/1 matrix."""
    packed = np.asarray(packed, dtype=np.uint32)
    if packed.ndim == 1:
        return unpack_fingerprints(packed[None, :], n_bits)[0]
    n, w = packed.shape
    shifts = np.arange(32, dtype=np.uint32)
    bits = ((packed[:, :, None] >> shifts) & 1).astype(np.uint8).reshape(n, w * 32)
    if n_bits is not None:
        bits = bits[:, :n_bits]
    return bits


def popcount(x: jnp.ndarray) -> jnp.ndarray:
    """Per-element population count of a uint32 array (SWAR, VPU-friendly)."""
    x = x.astype(jnp.uint32)
    x = x - ((x >> 1) & jnp.uint32(_M1))
    x = (x & jnp.uint32(_M2)) + ((x >> 2) & jnp.uint32(_M2))
    x = (x + (x >> 4)) & jnp.uint32(_M4)
    return ((x * jnp.uint32(_H01)) >> 24).astype(jnp.int32)


def popcount_rows(packed: jnp.ndarray) -> jnp.ndarray:
    """Total set-bit count per row of a packed ``[..., W]`` uint32 matrix."""
    return jnp.sum(popcount(packed), axis=-1, dtype=jnp.int32)


def popcount_rows_np(packed: np.ndarray) -> np.ndarray:
    """Host (numpy) row popcount for the reference builder / tests."""
    packed = np.asarray(packed, dtype=np.uint32)
    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(packed).sum(axis=-1, dtype=np.int32)
    lut = np.array([bin(i).count("1") for i in range(256)], dtype=np.int32)
    as_bytes = packed.view(np.uint8)
    return lut[as_bytes].sum(axis=-1, dtype=np.int32)


def random_fingerprints(
    n: int, n_bits: int = 1024, density: float = 0.1, seed: int = 0,
    chunk: int = 1 << 20,
) -> np.ndarray:
    """Random packed fingerprints ``[n, n_bits/32] uint32`` for tests/benchmarks.

    Density defaults to ~10% set bits — typical for 1024-bit Morgan r=2
    fingerprints of drug-like molecules. Generated in ``chunk``-row pieces
    so peak memory stays bounded at any ``n`` (the output itself is only
    ``n_bits/8`` bytes/row).
    """
    rng = np.random.default_rng(seed)
    w = packed_words(n_bits)
    out = np.empty((n, w), dtype=np.uint32)
    thresh = np.uint8(int(density * 256))
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        bits = (rng.integers(0, 256, size=(hi - lo, n_bits),
                             dtype=np.uint8) < thresh).astype(np.uint8)
        # Guarantee no all-zero fingerprint (Tanimoto undefined on empties).
        empty = bits.sum(axis=1) == 0
        if empty.any():
            bits[empty, rng.integers(0, n_bits, size=int(empty.sum()))] = 1
        out[lo:hi] = pack_fingerprints(bits)
    return out


def _fnv1a64(data: bytes) -> int:
    """FNV-1a 64-bit — the shared hash of the Python and native (C++)
    fallback fingerprinters; both must stay bit-identical."""
    h = 0xCBF29CE484222325
    for b in data:
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def _hash_fingerprint_bits(smiles: str, n_bits: int, radius: int = 2) -> np.ndarray:
    """Deterministic hash-based fingerprint used when RDKit is unavailable.

    Folds all byte-substrings of length 1..(2*radius+1) of the SMILES
    string into the bit space — a crude circular-substructure analogue that
    preserves the key property tests need: similar strings → similar
    fingerprints, deterministic across processes. The native batch
    fingerprinter (rad_tpu.native.smiles_fingerprints_native) computes the
    identical function multithreaded.
    """
    bits = np.zeros(n_bits, dtype=np.uint8)
    data = smiles.encode("utf-8")
    max_len = 2 * radius + 1
    for length in range(1, max_len + 1):
        for i in range(len(data) - length + 1):
            bits[_fnv1a64(data[i : i + length]) % n_bits] = 1
    if not bits.any():
        bits[0] = 1
    return bits


def smiles_fingerprint(smiles: str, n_bits: int = 1024, radius: int = 2) -> np.ndarray:
    """Packed Morgan-style fingerprint of one SMILES string.

    Uses RDKit's Morgan generator when importable (parity with
    reference examples/DUDEZ_example.ipynb:92-118); otherwise falls back to a
    deterministic hash-based fingerprint so the full pipeline runs in
    RDKit-free environments.
    """
    try:  # pragma: no cover - exercised only where rdkit is installed
        from rdkit import Chem
        from rdkit.Chem import rdFingerprintGenerator

        mol = Chem.MolFromSmiles(smiles)
        if mol is not None:
            gen = rdFingerprintGenerator.GetMorganGenerator(
                radius=radius, fpSize=n_bits
            )
            arr = np.zeros(n_bits, dtype=np.uint8)
            fp = gen.GetFingerprint(mol)
            for b in fp.GetOnBits():
                arr[b] = 1
            return pack_fingerprints(arr)
    except ImportError:
        pass
    return pack_fingerprints(_hash_fingerprint_bits(smiles, n_bits, radius))


def smiles_fingerprints(
    smiles: Sequence[str] | Iterable[str], n_bits: int = 1024, radius: int = 2
) -> np.ndarray:
    """Packed fingerprints ``[N, W]`` for a batch of SMILES strings.

    The library-ingestion data loader (reference: RDKit fingerprinting in
    examples/DUDEZ_example.ipynb:92-118). Prefers RDKit Morgan when
    importable; otherwise the multithreaded native C++ fingerprinter
    (bit-identical to the Python fallback); otherwise the Python loop.
    """
    smiles = list(smiles)
    try:  # pragma: no cover - exercised only where rdkit is installed
        import rdkit  # noqa: F401
        has_rdkit = True
    except ImportError:
        has_rdkit = False
    if not has_rdkit and len(smiles) > 64:
        try:
            from rad_tpu.native import smiles_fingerprints_native
            return smiles_fingerprints_native(smiles, n_bits=n_bits,
                                              radius=radius)
        except Exception:
            pass
    return np.stack([smiles_fingerprint(s, n_bits, radius) for s in smiles])
