"""HNSW graph storage: fixed-degree padded adjacency over packed fingerprints.

The device-resident replacement for usearch's variable-degree adjacency + b1 vector
store (reference: the usearch submodule, surveyed via its call sites —
rad/hnsw_service.py:219-232, rad/hnsw_server.py:144-161). Design choices:

* **Padded per-layer tables**: layer ``l`` is an ``[N_l, M_l] int32`` matrix
  with sentinel ``-1`` for absent edges; ``M_0 = 2*connectivity`` and
  ``M_l = connectivity`` above (usearch convention). Static shapes → clean
  XLA gathers, no CSR indirection on the hot path.
* **Level-sorted ids**: internal node ids are assigned so levels are
  non-increasing — node ids ``[0, N_l)`` are exactly the members of layer
  ``l``. Upper-layer tables are therefore dense (no id remapping), the entry
  point is node 0, and ``get_top_level_nodes`` is ``range(N_top)``.
* **id vs key**: like usearch, internal node ids are dense slot indices and
  user *keys* are arbitrary int64 (reference identity model:
  rad/hnsw_service.py:46-57). ``keys[node_id] -> key``; the inverse map is a
  host-side dict built lazily.

The array fields form a pytree so a graph can be passed straight into jitted
traversal/search code or sharded with ``jax.sharding``.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["HNSWGraph", "LayerStats", "NpzStreamWriter", "ArangeKeys",
           "DerivedLevels", "neighbor_valid_mask", "host_keys_view",
           "ADJ_SENTINEL_U32"]

# uint32 adjacency sentinel (tables whose layer has > 2**31 rows cannot use
# int32 -1; usearch's internal ids are 40-bit for the same reason)
ADJ_SENTINEL_U32 = np.uint32(0xFFFFFFFF)


def neighbor_valid_mask(row: np.ndarray) -> np.ndarray:
    """Edge-validity mask for an adjacency row/table of either dtype.

    ``int32`` tables pad with ``-1``; ``uint32`` tables (graphs whose ids
    exceed 2**31, e.g. the reference's 2B serving deployment,
    reference index.html:568-580) pad with ``0xFFFFFFFF``.
    """
    if row.dtype == np.uint32:
        return row != ADJ_SENTINEL_U32
    return row >= 0


class VirtualArray:
    """Tiny lazy stand-in for an ``[N]`` host array that is a pure function
    of the index — never materialized (2B int64 keys are 16 GB that the
    mmap'd serving file deliberately omits). Supports the indexing the
    serving/fork-API paths need; ``np.asarray`` materializes (only safe at
    test scale — the serving paths keep the virtual object, see
    :func:`host_keys_view`)."""

    dtype: np.dtype
    shape: tuple

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def __len__(self) -> int:
        return self.shape[0]

    def _eval(self, ids: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def __getitem__(self, idx):
        n = self.shape[0]
        if isinstance(idx, slice):
            return self._eval(np.arange(*idx.indices(n), dtype=np.int64))
        if np.ndim(idx) == 0:
            i = int(idx)
            if i < 0:
                i += n
            if not 0 <= i < n:
                raise IndexError(i)
            return self._eval(np.asarray([i], np.int64))[0]
        return self._eval(np.asarray(idx, np.int64))

    def __array__(self, dtype=None, copy=None):
        out = self._eval(np.arange(self.shape[0], dtype=np.int64))
        return out if dtype is None else out.astype(dtype)


class ArangeKeys(VirtualArray):
    """Identity key map: ``keys[i] == i`` (int64). The serving-file
    analogue of building the index with ``add(np.arange(n), ...)`` —
    ``meta['identity_keys']`` marks files that omit the keys member."""

    def __init__(self, n: int):
        self.shape = (int(n),)
        self.dtype = np.dtype(np.int64)

    def _eval(self, ids: np.ndarray) -> np.ndarray:
        return ids


class DerivedLevels(VirtualArray):
    """Per-node level derived from level-sorted ids: node ``i`` is on every
    layer ``l`` with ``i < N_l``, so ``level(i) = #{l : i < N_l} - 1``.
    Exact for any graph with level-sorted descending ids (this package's
    invariant); ``meta['derived_levels']`` marks files that omit the
    levels member."""

    def __init__(self, layer_sizes):
        self._sizes = np.asarray(layer_sizes, np.int64)
        self.shape = (int(self._sizes[0]),)
        self.dtype = np.dtype(np.int32)

    def _eval(self, ids: np.ndarray) -> np.ndarray:
        # level(i) = #{l : sizes[l] > i} - 1; sizes is descending, so the
        # count is a searchsorted over the L-element (negated, ascending)
        # sizes — O(N log L) with an [N] output. The broadcast form
        # ids[:, None] < sizes[None, :] materializes an [N, L] bool
        # (~2 GB transient at the proven 240M scale when device_put
        # evaluates a slim-loaded graph's levels).
        return (np.searchsorted(-self._sizes, -np.asarray(ids, np.int64),
                                side="left") - 1).astype(np.int32)


def host_keys_view(keys):
    """Host-indexable view of a graph's ``keys`` field: virtual keys pass
    through untouched (never materialized); device/mmap arrays become
    numpy. Use this instead of ``np.asarray(graph.keys)`` anywhere a
    billion-node serving graph can appear."""
    return keys if isinstance(keys, VirtualArray) else np.asarray(keys)


class NpzStreamWriter:
    """Stream an *uncompressed* ``.npz`` to disk member-by-member, in chunks.

    ``HNSWGraph.save`` materializes every array before ``np.savez`` — fine
    up to ~100M nodes, but a billion-node serving file (the reference's 2B
    deployment, reference index.html:568-580) is ~70 GiB of adjacency that
    should never exist in RAM at once. This writer produces byte-compatible
    archives (ZIP_STORED + zip64) that ``HNSWGraph.load(mmap=True)`` maps
    in place, while each member is fed as a sequence of row chunks.

        w = NpzStreamWriter(path)
        with w.member("neighbors_0", (n, 16), np.int32) as m:
            for chunk in chunks:      # [rows, 16] int32 pieces
                m.write(chunk)
        w.write_array("keys", np.arange(...))   # small members in one go
        w.close(meta_dict)                      # writes meta_json + directory
    """

    def __init__(self, path: str):
        import zipfile

        self._zip = zipfile.ZipFile(path, "w", zipfile.ZIP_STORED,
                                    allowZip64=True)

    class _Member:
        def __init__(self, fp, shape, dtype):
            self._fp = fp
            self._rows = 0
            self._shape = shape
            self._dtype = np.dtype(dtype)

        def write(self, chunk: np.ndarray) -> None:
            chunk = np.ascontiguousarray(chunk, dtype=self._dtype)
            lead = chunk.shape[0] if chunk.ndim else 1
            if chunk.ndim != len(self._shape) or \
                    chunk.shape[1:] != tuple(self._shape[1:]):
                raise ValueError(f"chunk shape {chunk.shape} does not extend "
                                 f"member shape {self._shape}")
            self._fp.write(memoryview(chunk).cast("B"))
            self._rows += lead

        def __enter__(self):
            return self

        def __exit__(self, exc_type, exc, tb):
            if exc_type is None and self._rows != self._shape[0]:
                raise ValueError(
                    f"member closed after {self._rows} rows; "
                    f"declared {self._shape[0]}")
            self._fp.close()
            return False

    def member(self, name: str, shape, dtype) -> "NpzStreamWriter._Member":
        """Open member ``name`` for chunked writes (use as a context mgr)."""
        import zipfile

        info = zipfile.ZipInfo(name + ".npy", date_time=(1980, 1, 1, 0, 0, 0))
        info.compress_type = zipfile.ZIP_STORED
        fp = self._zip.open(info, "w", force_zip64=True)
        np.lib.format.write_array_header_2_0(
            fp, {"descr": np.lib.format.dtype_to_descr(np.dtype(dtype)),
                 "fortran_order": False, "shape": tuple(shape)})
        return self._Member(fp, tuple(shape), dtype)

    def write_array(self, name: str, array: np.ndarray) -> None:
        array = np.asarray(array)
        with self.member(name, array.shape, array.dtype) as m:
            m.write(array)

    def close(self, meta: dict | None = None) -> None:
        if meta is not None:
            if "fp_format_version" not in meta:
                from rad_tpu.chem.morgan import FP_FORMAT_VERSION
                meta = {**meta, "fp_format_version": FP_FORMAT_VERSION}
            self.write_array("meta_json", np.frombuffer(
                json.dumps(meta).encode(), dtype=np.uint8))
        self._zip.close()


def _mmap_npz_members(path: str):
    """Memory-map every member of an *uncompressed* .npz in place.

    ``np.savez`` stores members with ZIP_STORED (no compression), so each
    embedded .npy sits contiguously in the file: parse its header at the
    zip-local offset and hand the data region to ``np.memmap``. Returns
    ``{name: memmap}`` or None if the archive can't be mapped (compressed
    members, unexpected layout, numpy internals changed) — callers fall
    back to an eager load.
    """
    import zipfile

    try:
        arrays = {}
        with zipfile.ZipFile(path) as z, open(path, "rb") as f:
            for info in z.infolist():
                if info.compress_type != zipfile.ZIP_STORED:
                    return None
                f.seek(info.header_offset)
                hdr = f.read(30)
                if hdr[:4] != b"PK\x03\x04":
                    return None
                name_len = int.from_bytes(hdr[26:28], "little")
                extra_len = int.from_bytes(hdr[28:30], "little")
                f.seek(info.header_offset + 30 + name_len + extra_len)
                version = np.lib.format.read_magic(f)
                shape, fortran, dtype = np.lib.format._read_array_header(
                    f, version)
                name = info.filename
                name = name[:-4] if name.endswith(".npy") else name
                arrays[name] = np.memmap(
                    path, dtype=dtype, mode="r", offset=f.tell(),
                    shape=shape, order="F" if fortran else "C")
        return arrays
    except Exception:
        return None


@dataclass
class LayerStats:
    """Per-layer statistics (parity with usearch ``levels_stats``,
    reference rad/hnsw_server.py:144-161)."""

    nodes: int
    edges: int
    max_edges: int
    allocated_bytes: int


@jax.tree_util.register_pytree_node_class
@dataclass
class HNSWGraph:
    """An HNSW graph over packed binary fingerprints.

    Array fields (pytree leaves):
      packed:     [N, W] uint32 — packed fingerprints (W = ndim/32)
      popcounts:  [N] int32     — per-row set-bit counts (precomputed)
      keys:       [N] int64     — node_id -> user key
      levels:     [N] int32     — node_id -> max layer (non-increasing in id)
      neighbors:  tuple over layers l of [N_l, M_l] int32, -1-padded

    Static fields (aux data):
      ndim, connectivity, layer_sizes
    """

    packed: jnp.ndarray
    popcounts: jnp.ndarray
    keys: jnp.ndarray
    levels: jnp.ndarray
    neighbors: Tuple[jnp.ndarray, ...]
    ndim: int
    connectivity: int

    _key_to_id: Dict[int, int] | None = dataclasses.field(
        default=None, repr=False, compare=False
    )

    # ---------------------------------------------------------------- pytree
    def tree_flatten(self):
        leaves = (self.packed, self.popcounts, self.keys, self.levels,
                  self.neighbors)
        aux = (self.ndim, self.connectivity)
        return leaves, aux

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        packed, popcounts, keys, levels, neighbors = leaves
        ndim, connectivity = aux
        return cls(packed, popcounts, keys, levels, tuple(neighbors),
                   ndim, connectivity)

    # ------------------------------------------------------------ properties
    def __len__(self) -> int:
        return int(self.packed.shape[0])

    @property
    def size(self) -> int:
        return len(self)

    @property
    def max_level(self) -> int:
        """Top layer index (usearch ``index.max_level``)."""
        return len(self.neighbors) - 1

    @property
    def dtype(self) -> str:
        return "b1"  # packed-bit storage, parity with usearch ScalarKind.B1

    @property
    def multi(self) -> bool:
        return False

    @property
    def capacity(self) -> int:
        return len(self)

    @property
    def memory_usage(self) -> int:
        """Bytes across all array fields (usearch ``index.memory_usage``)."""
        total = 0
        for arr in (self.packed, self.popcounts, self.keys, self.levels,
                    *self.neighbors):
            total += arr.size * arr.dtype.itemsize
        return int(total)

    @property
    def layer_sizes(self) -> Tuple[int, ...]:
        return tuple(int(t.shape[0]) for t in self.neighbors)

    def levels_stats(self) -> List[LayerStats]:
        """Per-layer node/edge stats (reference rad/hnsw_server.py:144-161).

        Cached after the first call: the edge count is a full scan of the
        adjacency (a one-time ~70 GB mmap read at 2B nodes — the /info
        route must not pay it per request). Files whose meta carries
        ``edges_per_layer`` (the streamed serving generator records it)
        skip the scan entirely.
        """
        cache = getattr(self, "_levels_stats_cache", None)
        if cache is not None:
            return cache
        stats = []
        for table in self.neighbors:
            t = np.asarray(table)
            stats.append(
                LayerStats(
                    nodes=int(t.shape[0]),
                    edges=int(neighbor_valid_mask(t).sum()),
                    max_edges=int(t.shape[0] * t.shape[1]),
                    allocated_bytes=int(t.size * t.dtype.itemsize),
                )
            )
        object.__setattr__(self, "_levels_stats_cache", stats)
        return stats

    # ----------------------------------------------------------- fork API
    # equivalents of the usearch fork's graph introspection
    # (reference rad/hnsw_service.py:219-232, examples/DUDEZ_example.ipynb:408).
    def get_neighbors(self, node_id: int, level: int) -> List[int]:
        """Adjacency of ``node_id`` at ``level`` as ``[id, key, id, key, ...]``.

        Flat alternating format — parity with the usearch fork's
        ``get_neighbors`` (reference rad/hnsw_service.py:219-225). Raises on
        an invalid (node, level) combination like the fork does
        (reference rad/hnsw_server.py:480-487).
        """
        if not 0 <= node_id < len(self):
            raise ValueError(f"node_id {node_id} out of range [0, {len(self)})")
        if not 0 <= level <= self.max_level:
            raise ValueError(
                f"level {level} out of range [0, {self.max_level}]")
        if node_id >= self.layer_sizes[level]:
            raise ValueError(
                f"node {node_id} does not exist on level {level}")
        row = np.asarray(self.neighbors[level][node_id])
        ids = row[neighbor_valid_mask(row)].astype(np.int64)
        keys = np.asarray(self.keys[ids])
        out: List[int] = []
        for i, k in zip(ids.tolist(), keys.tolist()):
            out.extend((int(i), int(k)))
        return out

    def get_top_level_nodes(self) -> List[int]:
        """All nodes on the top layer as ``[id, key, ...]`` (fork parity)."""
        n_top = self.layer_sizes[self.max_level]
        keys = np.asarray(self.keys[:n_top])
        out: List[int] = []
        for i in range(n_top):
            out.extend((i, int(keys[i])))
        return out

    def get_node_ids_from_keys(self, keys: Sequence[int]) -> List[int]:
        """Map user keys → internal node ids (fork parity,
        reference examples/DUDEZ_example.ipynb:405-409)."""
        if isinstance(self.keys, ArangeKeys):
            n = len(self)
            for k in keys:
                if not 0 <= int(k) < n:
                    raise KeyError(int(k))
            return [int(k) for k in keys]
        if self._key_to_id is None:
            host_keys = np.asarray(self.keys)
            object.__setattr__(
                self, "_key_to_id",
                {int(k): i for i, k in enumerate(host_keys.tolist())},
            )
        return [self._key_to_id[int(k)] for k in keys]

    # -------------------------------------------------------------- persist
    def save(self, path: str, exclude_vectors: bool = False,
             slim: bool = False) -> None:
        """Persist to an ``.npz`` (analogue of usearch file persistence).

        ``exclude_vectors=True`` omits the fingerprint matrix — the
        reference's serving deployment (``Index(path=..., view=True,
        exclude_vectors=True)``, scripts/start_hnsw_server.py:69): a
        2B-molecule adjacency serves /neighbors without the 256 GB of
        vectors. A graph loaded from such a file answers graph queries
        but cannot compute distances (``has_vectors`` is False).

        ``slim=True`` writes the v2 serving format on top of that: the
        keys and levels members are omitted (they are declared derivable
        in the meta — at 2B nodes they alone are 24 GB) and per-layer
        edge counts are recorded so ``levels_stats``/``/info`` never
        scan the adjacency. Requires identity keys (``keys[i] == i``,
        i.e. the index was built with ``add(np.arange(n), ...)``) and
        the package's level-sorted id invariant; raises ``ValueError``
        otherwise. For graphs too large to hold resident, write the file
        in chunks with :class:`NpzStreamWriter` instead (the
        benchmarks/bench_serving.py generator shows the recipe).
        """
        if slim:
            if not exclude_vectors:
                raise ValueError(
                    "slim=True is a serving-file mode and requires "
                    "exclude_vectors=True")
            if not isinstance(self.keys, ArangeKeys):
                k = np.asarray(self.keys)
                if not np.array_equal(k, np.arange(len(self),
                                                   dtype=k.dtype)):
                    raise ValueError(
                        "slim=True requires identity keys (keys[i] == i); "
                        "this graph's keys are not an arange — save "
                        "without slim")
            if not isinstance(self.levels, DerivedLevels):
                expect = np.asarray(DerivedLevels(self.layer_sizes))
                if not np.array_equal(np.asarray(self.levels), expect):
                    raise ValueError(
                        "slim=True requires level-sorted derived levels; "
                        "this graph's levels member disagrees with its "
                        "layer sizes — save without slim")
        arrays = {}
        if not slim:
            arrays["keys"] = np.asarray(self.keys)
            arrays["levels"] = np.asarray(self.levels)
        if not exclude_vectors:
            arrays["packed"] = np.asarray(self.packed)
            arrays["popcounts"] = np.asarray(self.popcounts)
        for l, t in enumerate(self.neighbors):
            arrays[f"neighbors_{l}"] = np.asarray(t)
        from rad_tpu.chem.morgan import FP_FORMAT_VERSION
        meta = {
            "ndim": self.ndim,
            "connectivity": self.connectivity,
            "n_layers": len(self.neighbors),
            "exclude_vectors": bool(exclude_vectors),
            "version": 2 if slim else 1,
            # in-tree Morgan format version at save time: a load under a
            # different current version means query fingerprints will
            # silently mismatch this index — rebuild (chem/morgan.py)
            "fp_format_version": FP_FORMAT_VERSION,
        }
        if slim:
            meta["identity_keys"] = True
            meta["derived_levels"] = True
            meta["edges_per_layer"] = [s.edges for s in self.levels_stats()]
        arrays["meta_json"] = np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8
        )
        np.savez(path, **arrays)

    @classmethod
    def load(cls, path: str, mmap: bool = True) -> "HNSWGraph":
        """Load from ``.npz``. ``mmap=True`` memory-maps the arrays lazily —
        the analogue of usearch ``Index(path=…, view=True)``
        (reference scripts/start_hnsw_server.py:69). ``np.load``'s own
        mmap_mode is silently ignored for .npz archives, so the members are
        mapped directly at their offsets inside the (uncompressed) zip;
        falls back to an eager load if the archive layout is unexpected."""
        data = (_mmap_npz_members(path) if mmap else None)
        if data is None:
            data = dict(np.load(path))
        meta = json.loads(bytes(data["meta_json"]).decode())
        saved_fpv = meta.get("fp_format_version")
        if saved_fpv is not None:
            from rad_tpu.chem.morgan import FP_FORMAT_VERSION
            if saved_fpv != FP_FORMAT_VERSION:
                logger.warning(
                    "%s was saved under Morgan fingerprint format v%s but "
                    "this build computes v%s — Morgan query fingerprints "
                    "will NOT match this index; rebuild it (non-Morgan "
                    "fingerprint sources are unaffected)",
                    path, saved_fpv, FP_FORMAT_VERSION)
        neighbors = tuple(
            data[f"neighbors_{l}"] for l in range(meta["n_layers"])
        )
        n = int(neighbors[0].shape[0])
        # v2 serving-file members: identity keys / level-sorted levels can
        # be derived instead of stored (2B nodes = 16 GB keys + 8 GB levels
        # the file omits; see NpzStreamWriter callers)
        keys = (ArangeKeys(n) if meta.get("identity_keys")
                else data["keys"])
        levels = (DerivedLevels([t.shape[0] for t in neighbors])
                  if meta.get("derived_levels") else data["levels"])
        if meta.get("exclude_vectors"):
            packed = np.zeros((n, 0), np.uint32)
            popcounts = np.zeros((n,), np.int32)
        else:
            packed = data["packed"]
            popcounts = data["popcounts"]
        graph = cls(
            packed=packed,
            popcounts=popcounts,
            keys=keys,
            levels=levels,
            neighbors=neighbors,
            ndim=meta["ndim"],
            connectivity=meta["connectivity"],
        )
        if "edges_per_layer" in meta:
            object.__setattr__(graph, "_levels_stats_cache", [
                LayerStats(nodes=int(t.shape[0]), edges=int(e),
                           max_edges=int(t.shape[0] * t.shape[1]),
                           allocated_bytes=int(t.size * t.dtype.itemsize))
                for t, e in zip(neighbors, meta["edges_per_layer"])])
        return graph

    # --------------------------------------------------------------- device
    def device_put(self, sharding=None) -> "HNSWGraph":
        """Move all arrays to device (optionally with a sharding)."""
        def put(x):
            return jax.device_put(jnp.asarray(x), sharding) if sharding \
                else jax.device_put(jnp.asarray(x))
        return HNSWGraph(
            packed=put(self.packed),
            popcounts=put(self.popcounts),
            # keys stay host-side: nothing device-side reads them, and
            # jnp.asarray would truncate int64 user keys to int32 (x64
            # is off); virtual keys pass through unmaterialized
            keys=host_keys_view(self.keys),
            levels=jnp.asarray(np.asarray(self.levels)),
            neighbors=tuple(put(t) for t in self.neighbors),
            ndim=self.ndim,
            connectivity=self.connectivity,
        )

    @property
    def has_vectors(self) -> bool:
        """False for graphs loaded from an ``exclude_vectors=True`` file
        (serving-only deployment; graph queries work, distances do not)."""
        return self.packed.shape[1] > 0

    def info(self) -> dict:
        """Metadata dict (parity with get_hnsw_info,
        reference rad/hnsw_service.py:400-412)."""
        return {
            "max_level": self.max_level,
            "size": len(self),
            "connectivity": self.connectivity,
            "dtype": self.dtype,
            "ndim": self.ndim,
            "capacity": self.capacity,
            "memory_usage": self.memory_usage,
            "multi": self.multi,
            "layer_sizes": list(self.layer_sizes),
        }
