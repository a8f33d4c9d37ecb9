"""SimHash serving (config 4): sign codes, the code index and its server.

The port of the serving half of ``randomprojection_tpu/models/sketch.py``:

- ``SignRandomProjection``: SimHash cosine-LSH.  Project onto k Gaussian
  hyperplanes, keep only the sign bits, packed 8 per byte on the device
  (``TorchBackend.transform_packed_signs``); Hamming distance between
  codes estimates the angle, ``cos(θ) ≈ cos(π·hamming/k)`` (Charikar 2002).
- ``SimHashIndex``: packed codes resident on the card in chunks, with
  tombstones, compaction, the dense ``query`` and the serving path
  ``query_topk``, which runs the fused top-k kernel
  (``ops/topk_kernels.py``, ``csrc/topk.cu``) on every chunk.
- ``TopKServer``: micro-batches concurrent requests into single
  ``query_topk`` calls.

The index and the server run on the card unless the caller asks for the
CPU (``SimHashIndex(..., device='cpu')``), where the kernel's plain
version serves.  ``save``/``load`` write and read the reference's durable
snapshot format (``durable.py``).  ``hbm_budget_bytes`` tiers the chunks
past a device-memory budget into pinned host memory or onto disk
(``tiering.py``).  ``mesh=`` splits every added chunk into one row block
per device of the mesh's data axis, each a chunk on its own device scored
by the kernel; the sharded serving tier (``serving.ShardedSimHashIndex``)
is N such single-device indexes.  The multi-probe LSH tier on top of the
index is
``ann.LSHSimHashIndex``; a ``TopKServer`` takes per-label probe budgets
for it (``probe_policy``).

- ``CountSketch``: the Count-Sketch / hashing-trick projection of config
  5, its ``h_``/``s_`` tables drawn on the host as the reference draws
  them, its dense, scatter and CSR routes run with torch ops on the card
  (none of them is a Pallas kernel in the reference).
"""

from __future__ import annotations

import numbers
import queue
import re
import threading
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np
import scipy.sparse as sp

from randomprojection_tpu_torch.models.base import BaseRandomProjection, ParamsMixin
from randomprojection_tpu_torch.ops import topk_kernels
# a tensor's copy to the host: pinned memory, non_blocking, an event
# behind it on a card; .result(None) waits for that copy alone
from randomprojection_tpu_torch.ops.staging import HostFetch, tile_pipeline
from randomprojection_tpu_torch.parallel.mesh import concrete_device
from randomprojection_tpu_torch.parallel.sharded import (
    row_bucket,
    token_balanced_bounds,
)
from randomprojection_tpu_torch.utils import telemetry
from randomprojection_tpu_torch.utils.observability import (
    annotate,
    perf_offset_ns,
    record_span,
    recording,
)
from randomprojection_tpu_torch.utils.telemetry import EVENTS
from randomprojection_tpu_torch.utils.validation import NotFittedError, check_array

__all__ = [
    "CountSketch",
    "DeviceBatch",
    "SignRandomProjection",
    "SimHashIndex",
    "TopKServer",
    "pairwise_hamming",
    "pairwise_hamming_device",
    "pairwise_hamming_sharded",
    "cosine_from_hamming",
    "topk_bruteforce",
]

class SignRandomProjection(BaseRandomProjection):
    """SimHash: sign bits of a Gaussian projection, packed to uint8.

    ``transform`` returns shape ``(n, ceil(k/8))`` uint8 codes (little-endian
    bit order within each byte; trailing pad bits are zero for every row, so
    they cancel in Hamming distances).  Use ``pairwise_hamming`` /
    ``cosine_from_hamming`` on the codes.  A tensor on the card gives codes
    on the card.
    """

    _kind = "gaussian"  # Gaussian hyperplanes = unbiased angle estimates
    _warn_on_expand = False  # k bits > d dims is normal LSH usage

    def _packed_signs_fn(self):
        """The backend's fused sign path, resolved once per backend (keyed
        on backend identity, so a refit re-resolves)."""
        cached = self.__dict__.get("_packed_cache")
        if cached is None or cached[0] is not self._backend:
            cached = (
                self._backend,
                getattr(self._backend, "transform_packed_signs", None),
            )
            self.__dict__["_packed_cache"] = cached
        return cached[1]

    def transform(self, X):
        self._check_is_fitted()
        X = self._validate_for_transform(X, self.n_features_in_, "features")
        packed = self._packed_signs_fn()
        if packed is not None:
            return packed(X, self._state, self.spec_)
        y = np.asarray(self._backend.transform(X, self._state, self.spec_))
        return np.packbits(y > 0, axis=-1, bitorder="little")

    def _transform_async(self, X):
        # the streaming variant: codes stay a device tensor where the
        # backend packs on the device
        self._check_is_fitted()
        X = self._validate_for_transform(X, self.n_features_in_, "features")
        packed = self._packed_signs_fn()
        if packed is not None:
            return packed(X, self._state, self.spec_, materialize=False)
        y = np.asarray(self._backend.transform(X, self._state, self.spec_))
        return np.packbits(y > 0, axis=-1, bitorder="little")

    def _stream_out_dtype(self):
        return np.uint8

    def _stream_out_width(self) -> int:
        return -(-self.n_components_ // 8)  # packed bytes per row

    def inverse_transform(self, Y):
        raise NotImplementedError(
            "Sign codes discard magnitudes; SimHash has no inverse. "
            "Use cosine_from_hamming for similarity estimates."
        )


def pairwise_hamming(A, B=None):
    """Hamming distances between packed sign codes on the host.

    ``A: (n1, nbytes)``, ``B: (n2, nbytes)`` (default ``B=A``) → ``(n1, n2)``
    int32; ``pairwise_hamming_device`` scores big code sets on the card.
    """
    A = np.asarray(A, dtype=np.uint8)
    B = A if B is None else np.asarray(B, dtype=np.uint8)
    return (
        np.bitwise_count(A[:, None, :] ^ B[None, :, :]).sum(-1).astype(np.int32)
    )


def pairwise_hamming_device(A, B=None, *, tile: int = 2048, device=None):
    """Device Hamming distances ``(n1, n2)`` int32 of ``A`` against ``B``
    (default ``B=A``): a one-shot ``SimHashIndex(B).query(A)``; hold a
    ``SimHashIndex`` to query one code set repeatedly."""
    A = np.asarray(A, dtype=np.uint8)
    return SimHashIndex(A if B is None else B, device=device).query(A, tile=tile)


def pairwise_hamming_sharded(A, B=None, *, mesh, data_axis: str = "data",
                             tile: int = 2048):
    """Hamming distances ``(n1, n2)`` int32 with the code set ``B``
    (default ``A``) row-sharded over ``mesh``'s ``data_axis``: each device
    holds a contiguous block of ``B``'s rows and scores every query tile
    against it; the result's column blocks are the devices' blocks, so it
    assembles on the host with no collective.  One-shot: a
    ``SimHashIndex(B, mesh=mesh)`` held across calls ships ``B`` once."""
    A = np.asarray(A, dtype=np.uint8)
    return SimHashIndex(
        A if B is None else B, mesh=mesh, data_axis=data_axis
    ).query(A, tile=tile)


def cosine_from_hamming(hamming, n_bits: int):
    """SimHash estimate: ``cos(π · hamming / k)`` (Charikar 2002)."""
    return np.cos(np.pi * np.asarray(hamming, dtype=np.float64) / n_bits)


def topk_bruteforce(A, B, m: int):
    """Host reference for ``SimHashIndex.query_topk``: exact top-``m``
    under the documented (distance, lower-global-id) total order.
    O(n_queries · n_codes) host work — verification and small data only."""
    D = pairwise_hamming(A, B).astype(np.int64)
    shift = max(int(D.shape[1]).bit_length(), 1)
    key = (D << shift) | np.arange(D.shape[1], dtype=np.int64)[None, :]
    sel = np.argsort(key, axis=1, kind="stable")[:, :m]
    return (
        np.take_along_axis(D, sel, axis=1).astype(np.int32),
        sel.astype(np.int32),
    )


class _IndexChunk:
    """One resident block of packed codes: ``b`` is ``(n, n_bytes)`` uint8
    on the index's device, ``n`` its row count, ``row0`` the global id of
    its first row.  ``dead_dev``/``dead_rev`` cache the chunk's device
    tombstone mask (None = no deleted rows) against the index's tombstone
    revision."""

    __slots__ = ("b", "n", "row0", "dead_dev", "dead_rev")

    def __init__(self, b, n: int, row0: int = 0):
        self.b = b
        self.n = n
        self.row0 = row0
        self.dead_dev = None
        self.dead_rev = -1


class SimHashIndex:
    """A persistent device-resident SimHash code index (config 4 serving).

    Codes live in device-resident CHUNKS: the constructor uploads one bulk
    chunk and every ``add`` uploads only the new codes as a fresh chunk.
    Queries score all chunks; global code ids are assigned in insertion
    order across chunks.  ``codes`` may be a host array or a uint8 tensor
    already on the card, which stays there.

    ``query`` returns the full ``(n_queries, n_codes)`` distance matrix
    (analysis scale).  The serving path is ``query_topk``: the top-``m``
    candidates of every chunk are selected on the device by the fused
    top-k kernel, and only ``O(m)`` values per query and chunk cross to
    the host, where the chunks merge.

    ``device=None`` is the card and raises when there is none; the CPU
    runs only when asked (``device='cpu'``), with the kernel's plain
    version.  At most ``2**31 - 1`` codes per index: device ids are int32.

    ``mesh`` (a ``parallel.Mesh``) row-shards the index over the devices
    of its ``data_axis``: every added chunk splits into one contiguous row
    block per device, each a chunk of its own on that device, and every
    query tile runs the kernel on each block; the chunks' candidates merge
    as any chunks' do, so the answers are the single-device index's.  A
    mesh may name one device several times (blocks then share it).

    ``hbm_budget_bytes`` tiers the index (``tiering.TieredResidency``):
    chunks are admitted to the device until their bytes reach the budget,
    later ones land cold (``cold_tier='host'``: a pinned host copy;
    ``'disk'``: a checksummed spill under ``cold_dir``), and the serving
    paths stage a cold chunk's rows on a side stream under the hot chunks'
    kernels.  Answers are those of the fully resident index, bit for bit.
    A tiered index runs a background worker: ``close()`` joins it.

    Thread-safety: queries may run concurrently with each other, but
    mutation (``add``/``delete``/``compact``) requires the index to be
    quiescent — drain a ``TopKServer`` before compacting.
    """

    def __init__(self, codes, *, mesh=None, data_axis: str = "data",
                 n_bits: Optional[int] = None,
                 device=None,
                 label: Optional[str] = None,
                 hbm_budget_bytes: Optional[int] = None,
                 cold_tier: str = "host", cold_dir: Optional[str] = None):
        if device is not None and mesh is not None:
            raise ValueError(
                "device= pins a single-device index; it cannot combine "
                "with mesh= (one index is one shard OR one mesh span)"
            )
        if hbm_budget_bytes is not None and mesh is not None:
            raise ValueError(
                "hbm_budget_bytes= tiers a single-device index; the mesh "
                "path shards residency across devices instead (tier the "
                "per-shard indexes of serving.ShardedSimHashIndex)"
            )
        self.mesh = mesh
        self.data_axis = data_axis
        # the devices of the mesh's data axis, one row block each (None:
        # the one device)
        self._block_devices = None
        if mesh is not None:
            from randomprojection_tpu_torch.parallel.mesh import (
                data_axis_devices,
            )

            self._block_devices = [
                concrete_device(d) for d in data_axis_devices(mesh, data_axis)
            ]
            self.device = self._block_devices[0]
        else:
            self.device = concrete_device(device)
        self.label = label
        codes = self._check_codes(codes, None)
        self.n_bytes = int(codes.shape[1])
        # ragged k (e.g. 20 bits in 3 bytes): pad bits are zero in every
        # code so they cancel in Hamming, but the cosine estimate must
        # divide by the REAL bit count
        self.n_bits = self.n_bytes * 8 if n_bits is None else int(n_bits)
        if not 0 < self.n_bits <= self.n_bytes * 8:
            raise ValueError(
                f"n_bits={self.n_bits} outside (0, {self.n_bytes * 8}]"
            )
        self._chunks: list = []
        self.n_codes = 0
        # tombstones: None until the first delete(), then a host bool
        # array over global ids; _dead_rev invalidates the per-chunk
        # device masks on mutation
        self._dead: Optional[np.ndarray] = None
        self._n_deleted = 0
        self._dead_rev = 0
        # tiered residency: None = every chunk on the device
        self._tier = None
        if hbm_budget_bytes is not None:
            from randomprojection_tpu_torch.tiering import TieredResidency

            self._tier = TieredResidency(
                int(hbm_budget_bytes), cold_tier=cold_tier,
                cold_dir=cold_dir, device=self.device,
            )
            self._tier.on_change = self._residency_changed
        if codes.shape[0]:
            self._upload_chunk(codes)

    @staticmethod
    def _check_codes(codes, n_bytes: Optional[int], what: str = "codes"):
        """Codes as a host uint8 array, or a uint8 tensor as given, checked
        for shape (``(n, n_bytes)`` once the width is known)."""
        import torch

        if isinstance(codes, torch.Tensor):
            if codes.dtype != torch.uint8:
                raise ValueError(f"{what} must be uint8, got {codes.dtype}")
        else:
            codes = np.asarray(codes, dtype=np.uint8)
        if codes.ndim != 2 or (n_bytes is not None and codes.shape[1] != n_bytes):
            want = "(n, nbytes)" if n_bytes is None else f"(n, {n_bytes})"
            raise ValueError(f"{what} must be {want}, got {tuple(codes.shape)}")
        return codes

    def _to_device(self, a, device=None):
        """One host array or tensor onto ``device`` (the index's device by
        default): host arrays are copied (through pinned memory and a
        ``non_blocking`` copy on a card), a tensor already on the device
        is kept as it is."""
        import torch

        device = self.device if device is None else device
        if isinstance(a, torch.Tensor):
            return a.to(device).contiguous()
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cpu":
            return t.clone()
        # rplint: allow[RP07] — stream order is the wait: the copy is queued on the current stream, every reader of the tensor runs on that stream behind it, and the host allocator keeps the pinned source until the copy has run
        return t.pin_memory().to(device, non_blocking=True)

    def _chunk_device(self, chunk):
        """The device a chunk is scored on: its own block's on a mesh, the
        index's otherwise (a cold chunk is staged there)."""
        return chunk.b.device if self._block_devices is not None else self.device

    def _on_chunk_devices(self, a_np) -> dict:
        """One query tile on every device a chunk lives on: device -> the
        uploaded tile (one upload a device)."""
        if self._block_devices is None:
            return {self.device: self._to_device(a_np)}
        out: dict = {}
        for c in self._chunks:
            dev = c.b.device
            if dev not in out:
                out[dev] = self._to_device(a_np, dev)
        return out

    def _codes_appended(self, codes, row0: int) -> None:
        """Subclass hook: ``codes`` (the chunk as given: a host array or a
        tensor) just became global rows ``[row0, row0 + len(codes))`` of
        this index.  Every append path (the constructor, ``add``,
        ``compact``'s re-upload) funnels through ``_upload_chunk`` and
        lands here.  The multi-probe LSH tier (``ann.LSHSimHashIndex``)
        folds the new rows into its bucket index from this hook, copying a
        tensor chunk to the host once; the base index keeps no derived
        structures and copies nothing."""

    def _upload_chunk(self, codes):
        n = int(codes.shape[0])
        if self.n_codes + n >= 2**31:
            # every device-side id and the returned idx are int32: past
            # 2^31-1 codes local ids would wrap, so refuse loudly
            who = (
                f"SimHashIndex {self.label!r}" if self.label
                else "SimHashIndex"
            )
            raise ValueError(
                f"{who} is limited to 2**31 - 1 codes (int32 device-local "
                f"ids); have {self.n_codes}, adding {n} would overflow. "
                "Grow past int32 by sharding over more devices "
                "(serving.ShardedSimHashIndex keeps global ids int64 and "
                "this bound per shard)"
            )
        if self._block_devices is not None:
            # one contiguous row block per device of the data axis, each a
            # chunk of its own (the balanced split: the first n % p blocks
            # take one row more)
            p = len(self._block_devices)
            lo = 0
            for j, dev in enumerate(self._block_devices):
                rows = n // p + (1 if j < n % p else 0)
                if rows:
                    self._chunks.append(_IndexChunk(
                        self._to_device(codes[lo: lo + rows], dev), rows,
                        self.n_codes + lo))
                lo += rows
        else:
            hot = self._tier is None or self._tier.admit(n * self.n_bytes)
            if hot:
                b = self._to_device(codes)
            else:
                # past the budget: the chunk lands cold and its rows are
                # staged per query instead of residing
                b = self._tier.place_cold(_host_rows_of(codes))
            chunk = _IndexChunk(b, n, self.n_codes)
            self._chunks.append(chunk)
            if self._tier is not None:
                self._tier.register(chunk, n * self.n_bytes, hot)
        if self._dead is not None:
            self._dead = np.concatenate([self._dead, np.zeros(n, dtype=bool)])
        row0 = self.n_codes
        self.n_codes += n
        self._codes_appended(codes, row0)

    def add(self, codes):
        """Append codes as a new resident chunk — ships only the new rows."""
        codes = self._check_codes(codes, self.n_bytes)
        if codes.shape[0]:
            self._upload_chunk(codes)
        return self

    # -- online mutation: tombstones + compaction ------------------------------

    @property
    def n_deleted(self) -> int:
        """Codes tombstoned by ``delete`` and not yet folded by ``compact``."""
        return self._n_deleted

    @property
    def n_live(self) -> int:
        """Codes that can still win a query: ``n_codes - n_deleted``."""
        return self.n_codes - self._n_deleted

    def delete(self, ids) -> int:
        """Tombstone codes by global id; returns how many were newly
        deleted (already-deleted ids are idempotent).

        Deleted codes keep their global ids but are filtered inside
        ``query_topk``'s selection, so a deleted code never appears in a
        result; ``query`` still covers every id.  ``compact()`` folds the
        tombstones and reclaims the device memory."""
        ids = np.atleast_1d(np.asarray(ids))
        if ids.size == 0:
            return 0
        if not np.issubdtype(ids.dtype, np.integer):
            raise ValueError(
                f"delete ids must be integers, got dtype {ids.dtype}"
            )
        # dedupe before counting: a duplicate id must count once
        ids = np.unique(ids)
        lo, hi = int(ids.min()), int(ids.max())
        if lo < 0 or hi >= self.n_codes:
            raise ValueError(
                f"delete ids must be in [0, {self.n_codes}), got "
                f"[{lo}, {hi}]"
            )
        if self._dead is None:
            self._dead = np.zeros(self.n_codes, dtype=bool)
        newly = int(np.count_nonzero(~self._dead[ids]))
        if newly:
            self._dead[ids] = True
            self._n_deleted += newly
            self._dead_rev += 1  # invalidate per-chunk device masks
        return newly

    def _chunk_dead_device(self, chunk):
        """The chunk's device tombstone mask ``(n,)`` uint8 (1 = deleted),
        or None when it has no deleted rows — the unmasked kernel variant
        then serves it.  Cached per chunk against ``_dead_rev``."""
        if self._dead is None:
            return None
        if chunk.dead_rev == self._dead_rev:
            return chunk.dead_dev
        sl = self._dead[chunk.row0: chunk.row0 + chunk.n]
        chunk.dead_dev = (
            self._to_device(sl.astype(np.uint8), self._chunk_device(chunk))
            if sl.any() else None
        )
        chunk.dead_rev = self._dead_rev
        return chunk.dead_dev

    def compact(self) -> np.ndarray:
        """Fold tombstones and merge every chunk into ONE resident chunk;
        returns the old global ids of the surviving codes in their new id
        order (``new id i`` was ``mapping[i]``).  A host rebuild and one
        full re-upload: a maintenance operation, not a serving one, and
        not safe under concurrent queries."""
        parts = [self._fetch_chunk_host(c) for c in self._chunks]
        codes = (
            np.concatenate(parts, axis=0)
            if parts
            else np.empty((0, self.n_bytes), np.uint8)
        )
        if self._dead is not None:
            mapping = np.flatnonzero(~self._dead).astype(np.int64)
            codes = codes[~self._dead]
        else:
            mapping = np.arange(self.n_codes, dtype=np.int64)
        self._rebuild_from_host(codes)
        return mapping

    def _fetch_chunk_host(self, chunk) -> np.ndarray:
        """Host copy of one chunk's rows, hot or cold: one ``.cpu()`` copy
        or a read of the cold copy, used only by the snapshot and
        compaction paths, never per query."""
        from randomprojection_tpu_torch.tiering import host_view

        b = chunk.b
        if getattr(b, "is_cuda", False):
            return b.cpu().numpy()
        return np.array(host_view(b), copy=True)

    def _residency_changed(self) -> None:
        """Hook of the tier's swaps and reset (subclasses drop what bakes a
        chunk's device pointer in)."""

    def _resident_codes(self, chunk, *, audit: bool = False):
        """The chunk's codes on the index's device: its binding when that
        is a device tensor, else a synchronous upload of the host copy (a
        cold chunk, or one demoted under a dispatch, counted on the
        tier's fallback audit when ``audit``)."""
        from randomprojection_tpu_torch.tiering import is_resident

        b = chunk.b
        if is_resident(b, self._chunk_device(chunk)):
            return b
        if audit and self._tier is not None:
            self._tier.note_fallback("demoted_under_dispatch",
                                     rows=int(chunk.n))
        return self._sync_upload(b)

    def close(self) -> None:
        """Join the tiered-residency worker when one exists (idempotent; a
        no-op for an untiered index).  A tiered index should be closed
        before the process exits."""
        if self._tier is not None:
            self._tier.close()

    def _rebuild_from_host(self, codes: np.ndarray) -> None:
        """Replace every resident chunk with ONE chunk holding ``codes``
        (the live code set in id order) and clear the tombstones."""
        old_n, old_chunks = self.n_codes, len(self._chunks)
        if self._tier is not None:
            # forget residency and this generation's spills; the caller
            # guarantees quiescence
            self._tier.reset()
        self._chunks = []
        self.n_codes = 0
        self._dead = None
        self._n_deleted = 0
        self._dead_rev += 1
        if codes.shape[0]:
            self._upload_chunk(np.ascontiguousarray(codes))
        telemetry.registry().counter_inc("simhash.compactions")
        telemetry.emit(
            EVENTS.INDEX_COMPACT, chunks_before=old_chunks,
            chunks_after=len(self._chunks), n_codes=self.n_codes,
            dropped=int(old_n - self.n_codes),
        )

    def _restore_tombstones(self, dead: np.ndarray) -> None:
        """Re-arm a restored tombstone bitmap (``durable.load_index``):
        the host mask, its count, and a new revision so every chunk's
        device mask is rebuilt at the next query."""
        self._dead = dead
        self._n_deleted = int(dead.sum())
        self._dead_rev += 1

    def save(self, path: str) -> dict:
        """Durable snapshot of the index into directory ``path``:
        per-chunk ``.npy`` spills plus a versioned, checksummed
        ``manifest.json`` committed write-tmp → fsync → ``os.replace``
        (see ``durable.save_index``).  Returns the manifest."""
        from randomprojection_tpu_torch import durable

        return durable.save_index(self, path)

    @classmethod
    def load(cls, path: str, *, device=None, mesh=None,
             data_axis: str = "data"):
        """Restore an index saved by ``save`` (by either package) onto
        ``device`` (None: the card) or row-sharded over ``mesh``: manifest
        version and per-chunk checksums are verified before upload; chunk
        structure and the tombstone bitmap round-trip exactly (see
        ``durable.load_index``)."""
        from randomprojection_tpu_torch import durable

        return durable.load_index(path, device=device, mesh=mesh,
                                  data_axis=data_axis)

    # -- dense distances ----------------------------------------------------------

    def _check_queries(self, A):
        """Queries as a host uint8 array (or a uint8 tensor as given) of
        this index's width."""
        return self._check_codes(A, self.n_bytes, "queries")

    def query(self, A, *, tile: int = 2048):
        """Hamming distances ``(n_queries, n_codes)`` int32 against the
        resident index; only the query tiles cross to the device.
        Analysis scale — use ``query_topk`` for serving.  Each tile's
        copy to the host starts at dispatch and is read one tile behind."""
        A = self._check_queries(A)
        out = np.empty((A.shape[0], self.n_codes), dtype=np.int32)

        def dispatch(lo, hi):
            a = self._on_chunk_devices(A[lo:hi])
            fetches = [
                HostFetch(topk_kernels.hamming_counts(
                    a[self._chunk_device(c)], self._resident_codes(c)))
                for c in self._chunks]
            telemetry.registry().counter_inc(
                "simhash.chunk_dispatches", len(self._chunks)
            )
            if telemetry.enabled():
                telemetry.emit(
                    EVENTS.SIMHASH_QUERY_TILE, queries=int(hi - lo),
                    chunks=len(self._chunks), n_codes=self.n_codes,
                    **telemetry.trace_fields(),
                )
            return fetches

        def finish(lo, hi, fetches):
            for c, f in zip(self._chunks, fetches):
                out[lo:hi, c.row0: c.row0 + c.n] = f.result(None)

        tile_pipeline(A.shape[0], tile, dispatch, finish)
        return out

    def query_cosine(self, A, *, tile: int = 2048):
        """SimHash cosine estimates against the resident index."""
        return cosine_from_hamming(self.query(A, tile=tile), self.n_bits)

    # -- serving path: device top-k --------------------------------------------

    def query_topk(self, A, m: int, *, tile: int = 2048):
        """Top-``m`` nearest codes per query, selected on the device.

        Returns ``(dist, idx)``, each ``(n_queries, m_eff)`` int32 with
        ``m_eff = min(m, n_live)``, sorted by ascending Hamming distance;
        exact ties go to the LOWER global id, so the result is identical
        across chunk layouts and tiling.  Every query tile runs the fused
        top-k kernel once per chunk (its two passes); the chunks' ``m``
        candidates per query merge on the host.  On a card ``m_eff`` is
        at most ``topk_kernels.MAX_M`` (a ``ValueError`` past it); a CPU
        index serves any ``m`` with the kernel's plain version.  Traced,
        a call is the span ``rp:index/query_topk``."""
        with annotate("rp:index/query_topk"):
            if not isinstance(m, numbers.Integral) or m <= 0:
                raise ValueError(f"m must be a positive int, got {m!r}")
            A = self._check_queries(A)
            if self.n_codes == 0:
                raise ValueError("query_topk on an empty index")
            if self.n_live == 0:
                raise ValueError(
                    "query_topk on an index whose codes are all deleted "
                    "(tombstoned); compact() or add() live codes first"
                )
            # m_eff counts LIVE codes only: tombstoned rows never win, and
            # the result width never includes sentinel filler
            m_eff = int(min(m, self.n_live))
            self._check_m(m_eff)
            nq = A.shape[0]
            out_d = np.empty((nq, m_eff), dtype=np.int32)
            out_i = np.empty((nq, m_eff), dtype=np.int32)

            def finish(lo, hi, handles):
                out_d[lo:hi], out_i[lo:hi] = self._topk_finish_tile(
                    handles, m_eff)

            # tiles finish one behind: tile i's copy to the host and its
            # merge ride under tile i+1's kernels
            tile_pipeline(
                nq, tile,
                lambda lo, hi: self._topk_dispatch_tile(A[lo:hi], m_eff),
                finish)
            return out_d, out_i

    def _check_m(self, m_eff: int) -> None:
        """A card index serves ``m`` up to the kernel's ``MAX_M``; past it
        the port has no other route and refuses, naming the index."""
        if self.device.type == "cuda" and m_eff > topk_kernels.MAX_M:
            where = (f"{self.label}" if self.label
                     else f"an index on {self.device}")
            raise ValueError(
                f"query_topk m={m_eff} exceeds the kernel's largest m "
                f"(MAX_M={topk_kernels.MAX_M}) for {where}"
            )

    # -- tile-level dispatch/finish halves (shared with the sharded tier) ------

    def _topk_dispatch_tile(self, a_np, m_eff: int) -> list:
        """Dispatch one query tile against every resident chunk and start
        each result's copy to the host; returns the per-chunk
        ``(dist, idx)`` fetches for ``_topk_finish_tile``.  Traced: the
        span ``rp:index/dispatch_tile``."""
        with annotate("rp:index/dispatch_tile"):
            a_on = self._on_chunk_devices(a_np)
            stager = None
            if self._tier is not None and self._tier.any_cold():
                from randomprojection_tpu_torch.tiering import _TileStager

                stager = _TileStager(self._chunks, self._tier,
                                     self._sync_upload)
            handles = []
            for ci, c in enumerate(self._chunks):
                # the stager hands back a cold chunk's staged copy (its
                # upload started under the previous chunk's kernel) and
                # starts the next cold chunk's upload before this kernel is
                # launched
                b = stager.resolve(ci) if stager is not None else None
                d, i = self._chunk_topk(a_on[self._chunk_device(c)], c,
                                        int(min(m_eff, c.n)), b=b)
                handles.append((HostFetch(d), HostFetch(i)))
            if stager is not None:
                stager.finish()
            telemetry.registry().counter_inc(
                "simhash.chunk_dispatches", len(self._chunks)
            )
            if telemetry.enabled():
                telemetry.emit(
                    EVENTS.SIMHASH_TOPK_TILE, queries=int(a_np.shape[0]),
                    m=int(m_eff), chunks=len(self._chunks),
                    n_codes=self.n_codes,
                    **telemetry.trace_fields(),
                )
            return handles

    def _topk_finish_tile(self, handles: list, m_eff: int):
        """Wait for one tile's per-chunk candidates and merge them across
        chunks under the (distance, lower-id) total order.  Returns
        ``(dist, idx)`` host arrays, each ``(tile_rows, m_eff)`` int32.
        Traced: the host's wait for the card is ``rp:index/wait_tile``,
        the merge ``rp:index/merge_tile``."""
        with annotate("rp:index/wait_tile"):
            got = [(d.result(None), i.result(None)) for d, i in handles]
        with annotate("rp:index/merge_tile"):
            # a chunk's local ids widen before its offset is added, so an
            # empty slot's id cannot wrap; live slots fill m_eff, and so no
            # empty slot is ever chosen
            d, i = topk_kernels.merge_topm(
                [d for d, _i in got],
                [i if c.row0 == 0 else i.astype(np.int64) + c.row0
                 for c, (_d, i) in zip(self._chunks, got)],
                m_eff)
            return d, i.astype(np.int32, copy=False)

    def _sync_upload(self, b):
        """The degraded rung of a staged upload: a cold binding uploaded on
        the current stream (pinned, ``non_blocking``: ordered before the
        kernel that reads it)."""
        import torch

        # a memmap is read-only: torch takes a writable copy of it
        return self._to_device(b if isinstance(b, torch.Tensor) else np.array(b))

    def _chunk_topk(self, a, chunk, m_c: int, b=None):
        """Device top-``m_c`` of one chunk for one query tile: ``(dist,
        local_idx)``, each ``(t, m_c)`` int32, from the fused top-k
        kernel (its plain version on the CPU).  Pad and tombstoned rows
        never enter the selection; a chunk with no deletions runs the
        unmasked variant.  ``b`` overrides the chunk's binding (the tiered
        path passes a cold chunk's staged copy); a binding that is not on
        the device (demoted under this dispatch) is uploaded here."""
        dead = self._chunk_dead_device(chunk)
        if b is None:
            b = self._resident_codes(chunk, audit=True)
        d, i = topk_kernels.fused_topk(a, b, chunk.n, m_c, dead=dead)
        if telemetry.enabled():
            telemetry.emit(
                EVENTS.TOPK_KERNEL_DISPATCH, queries=int(a.shape[0]),
                m=int(m_c), rows=int(chunk.n), masked=dead is not None,
                **telemetry.trace_fields(),
            )
        return d, i


def _host_rows_of(codes) -> np.ndarray:
    """A chunk's codes as a host array (a tensor on the card is copied)."""
    import torch

    if isinstance(codes, torch.Tensor):
        return codes.cpu().numpy()
    return np.asarray(codes)


def _metric_label(label) -> str:
    """Sanitize a client label for a registry metric name
    (``serve.latency.<server>.client.<label>``): characters other than
    alphanumerics, ``_``, ``.`` and ``-`` become ``_``, capped at 64."""
    s = re.sub(r"[^A-Za-z0-9_.\-]", "_", str(label))[:64]
    return s or "_"


class TopKServer:
    """Micro-batching front-end for ``SimHashIndex.query_topk`` (config-4
    serving under concurrent traffic).

    Callers ``submit()`` (returns a ``concurrent.futures.Future``) or
    ``query()`` (blocking) from any thread.  A dispatcher thread drains the
    queue, stacks up to ``max_batch`` query rows (waiting at most
    ``max_delay_s`` for stragglers once a request is in hand), pads the
    batch to a row bucket (``parallel.sharded.row_bucket``), runs ONE
    ``query_topk`` and scatters each request's rows back to its future.
    Results equal per-request ``query_topk`` calls: the selection is
    independent per query row.  ``m`` is fixed per server.

    ``probe_policy`` (an LSH-tier index only): ``{label: probes}``.  A
    batch splits by the labels' probe budgets and each class runs its own
    ``query_topk(..., probes=p)``; unlabelled requests and labels outside
    the policy keep the index's default probes, and 0 pins a label onto
    the exact path.

    The dispatcher pins the index's card in its own thread and launches on
    that thread's current stream.

    Shutdown: ``close()`` serves every request already submitted, then
    stops the dispatcher; ``submit()`` after close fails fast.  A failed
    batch reaches every caller through its future and emits
    ``serve.topk.error`` (plus the ``serve.topk.errors`` counter); the
    server keeps serving.  The index must not be mutated while the server
    is live.

    Backpressure: the queue is bounded (``max_pending`` requests); past it
    ``submit()`` raises ``RuntimeError`` (counted in ``serve.topk.rejects``).

    Latency: every request is stamped at enqueue, dispatch and completion
    into log2 histograms on the process registry, keyed per server name
    (``serve.latency.<name>``, plus ``.client.<label>`` for labelled
    requests); ``stats()["latency"]`` carries their quantiles.
    """

    _SENTINEL = object()

    def __init__(self, index: SimHashIndex, m: int, *,
                 max_batch: int = 8192, max_delay_s: float = 0.002,
                 max_pending: int = 8192, name: str = "topk",
                 probe_policy: Optional[dict] = None,
                 start: bool = True):
        if not isinstance(m, numbers.Integral) or m <= 0:
            raise ValueError(f"m must be a positive int, got {m!r}")
        if probe_policy is not None:
            # per-label probe classes: label -> probes, keyed by the
            # sanitized label (submit sanitizes before routing); 0 pins a
            # label onto the exact path
            if not isinstance(probe_policy, dict):
                raise ValueError(
                    f"probe_policy must be a dict of label -> probes, "
                    f"got {probe_policy!r}"
                )
            if not hasattr(index, "probes"):
                raise ValueError(
                    "probe_policy requires an LSH-tier index (its "
                    "query_topk must accept probes=); got "
                    f"{type(index).__name__}"
                )
            pol = {}
            for k, v in probe_policy.items():
                if (isinstance(v, bool)
                        or not isinstance(v, numbers.Integral) or v < 0):
                    raise ValueError(
                        f"probe_policy[{k!r}] must be a non-negative "
                        f"int, got {v!r}"
                    )
                pol[_metric_label(k)] = int(v)
            probe_policy = pol
        self.probe_policy = probe_policy
        if not isinstance(max_batch, numbers.Integral) or max_batch < 1:
            raise ValueError(
                f"max_batch must be a positive int, got {max_batch!r}"
            )
        if max_delay_s < 0:
            raise ValueError(f"max_delay_s must be >= 0, got {max_delay_s!r}")
        if not isinstance(max_pending, numbers.Integral) or max_pending < 1:
            raise ValueError(
                f"max_pending must be a positive int, got {max_pending!r}"
            )
        if not isinstance(name, str) or not name:
            raise ValueError(f"name must be a non-empty str, got {name!r}")
        self.index = index
        self.m = int(m)
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_s)
        self.max_pending = int(max_pending)
        self.name = name
        self._lat_name = f"serve.latency.{name}"
        # bounded: a stalled drain rejects new submits; the extra slot is
        # close()'s sentinel
        self._q: queue.Queue = queue.Queue(maxsize=self.max_pending + 1)
        self._closed = threading.Event()
        # serializes submit's closed-check+put against close's
        # set+sentinel, so every accepted request is queued ahead of the
        # sentinel and served by the drain
        self._submit_lock = threading.Lock()
        # dispatcher-thread-private tallies, read by stats() without the
        # lock: a snapshot whose fields may be one batch apart
        self._batches = 0
        self._requests = 0
        self._queries = 0
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "TopKServer":
        if self._closed.is_set():
            raise RuntimeError(
                "server closed: cannot start() a closed TopKServer — "
                "construct a new one"
            )
        if self._thread is not None:
            raise RuntimeError("TopKServer already started")
        self._thread = threading.Thread(
            target=self._run, name="rp-topk-server", daemon=True
        )
        self._thread.start()
        return self

    def close(self) -> None:
        """Drain-and-stop: requests already submitted are still served."""
        with self._submit_lock:
            if self._closed.is_set():
                return
            self._closed.set()
            # rplint: allow[RP11] — never blocks by construction: the queue is sized max_pending + 1 and submit() bounds occupancy to max_pending under this same lock, so the sentinel's extra slot is always free
            self._q.put(self._SENTINEL)
        if self._thread is not None:
            self._thread.join()

    def __enter__(self) -> "TopKServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- request surface ----------------------------------------------------

    def submit(self, codes, *, label: Optional[str] = None):
        """Enqueue one request of packed codes ``(rows, n_bytes)`` (a 1-D
        code is one row) and return a Future of its ``(dist, idx)``, each
        ``(rows, m_eff)`` int32, identical to a direct ``query_topk``.
        ``label`` names the client in the latency histograms."""
        t_enq = time.perf_counter()
        if label is not None:
            label = _metric_label(label)
        codes = np.asarray(codes, dtype=np.uint8)
        if codes.ndim == 1:
            codes = codes[None, :]
        codes = self.index._check_queries(codes)
        if codes.shape[0] == 0:
            raise ValueError("empty request (0 query rows)")
        fut: Future = Future()
        with self._submit_lock:
            if self._closed.is_set():
                raise RuntimeError(
                    "server closed: TopKServer.submit() after close() — "
                    "the dispatcher no longer drains the queue"
                )
            if self._q.qsize() >= self.max_pending:
                telemetry.registry().counter_inc("serve.topk.rejects")
                raise RuntimeError(
                    f"TopKServer submit queue is full (max_pending="
                    f"{self.max_pending} requests waiting; the dispatcher "
                    "is not draining — device hung or server overloaded)"
                )
            self._q.put_nowait((codes, fut, label, t_enq))
        return fut

    def query(self, codes, *, label: Optional[str] = None):
        """Blocking convenience: ``submit(codes).result()``."""
        return self.submit(codes, label=label).result()

    def stats(self) -> dict:
        """Served batches/requests/queries, the mean rows per coalesced
        dispatch and (once a request has completed) the enqueue→complete
        latency quantiles."""
        # rplint: allow[RP10] — dispatcher-private monotone int tallies: rebinds are GIL-atomic and stats() is a best-effort snapshot (cross-field staleness acceptable by contract, see the __init__ comment)
        b, r, q = self._batches, self._requests, self._queries
        out = {
            "batches": b,
            "requests": r,
            "queries": q,
            "rows_per_batch_mean": round(q / b, 2) if b else 0.0,
        }
        lat = telemetry.registry().hist_quantiles(self._lat_name)
        if lat is not None:
            out["latency"] = lat
        return out

    # -- dispatcher ---------------------------------------------------------

    def _pick_index(self):
        """The index one coalesced dispatch runs against.  The sharded
        tier's ``serving.ShardedTopKServer`` round-robins replica groups
        here (dispatcher thread only)."""
        return self.index

    def _batch_served(self, index, rows: int, padded: int,
                      requests: int, wall: float) -> None:
        """Hook after each successful coalesced dispatch (dispatcher
        thread); the sharded tier counts its ``serve.shard.*`` here."""

    def _collect(self, first):
        """One coalesced batch: ``first`` plus whatever arrives within
        ``max_delay_s``, capped at ``max_batch`` rows.  Returns
        ``(requests, saw_sentinel)``."""
        batch = [first]
        rows = first[0].shape[0]
        deadline = time.perf_counter() + self.max_delay_s
        while rows < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if item is self._SENTINEL:
                return batch, True
            batch.append(item)
            rows += item[0].shape[0]
        return batch, False

    def _serve(self, batch) -> None:
        """Run one coalesced dispatch (one per probe class when a
        ``probe_policy`` is set: labels with different probe budgets cannot
        share a candidate dispatch) and scatter its results."""
        if self.probe_policy is None:
            self._serve_group(batch, None)
            return
        groups: dict = {}
        for req in batch:
            p = self.probe_policy.get(req[2]) if req[2] is not None else None
            groups.setdefault(p, []).append(req)
        for p, group in groups.items():
            self._serve_group(group, p)

    def _serve_group(self, batch, probes: Optional[int]) -> None:
        """One coalesced ``query_topk`` for one probe class; unlabelled
        traffic (``probes=None``) keeps the index's own default.  Traced,
        the batch is the span ``rp:serve/batch`` and each request's wait
        from ``submit`` to the dispatch ``rp:serve/queue_wait``."""
        with annotate("rp:serve/batch"):
            arr = (
                batch[0][0]
                if len(batch) == 1
                else np.concatenate([req[0] for req in batch], axis=0)
            )
            n = arr.shape[0]
            # bucket-pad the rows so the kernel sees a few plan shapes, not
            # one per traffic mix (pad rows are scored and dropped)
            pad_to = row_bucket(n)
            if pad_to != n:
                arr = np.pad(arr, ((0, pad_to - n), (0, 0)))
            index = self._pick_index()
            t0 = time.perf_counter()
            kw = {} if probes is None else {"probes": probes}
            try:
                d, i = index.query_topk(arr, self.m, tile=pad_to, **kw)
            except BaseException as e:
                # every caller sees the exception through its future; the
                # failed dispatch also lands on the telemetry spine
                telemetry.registry().counter_inc("serve.topk.errors")
                telemetry.emit(
                    EVENTS.SERVE_TOPK_ERROR, error=repr(e), rows=int(n),
                    requests=len(batch), m=int(self.m),
                )
                for req in batch:
                    fut = req[1]
                    if fut.set_running_or_notify_cancel():
                        fut.set_exception(e)
                return
            wall = time.perf_counter() - t0
            self._batches += 1
            self._requests += len(batch)
            self._queries += n
            reg = telemetry.registry()
            reg.counter_inc("serve.topk.batches")
            tel = telemetry.enabled()
            if tel:
                telemetry.emit(
                    EVENTS.SERVE_TOPK_BATCH, rows=int(n), padded=int(pad_to),
                    requests=len(batch), m=int(self.m), wall_s=round(wall, 6),
                    **({} if probes is None else {"probes": int(probes)}),
                )
            self._batch_served(index, n, pad_to, len(batch), wall)
            lo = 0
            for codes, fut, label, t_enq in batch:
                hi = lo + codes.shape[0]
                if fut.set_running_or_notify_cancel():
                    fut.set_result((d[lo:hi], i[lo:hi]))
                # enqueue (submit), dispatch (t0) and completion stamps
                t_comp = time.perf_counter()
                total = t_comp - t_enq
                queue_wait = t0 - t_enq
                reg.observe(self._lat_name, total)
                reg.observe(self._lat_name + ".queue_wait", queue_wait)
                reg.observe(self._lat_name + ".serve", wall)
                if label is not None:
                    reg.observe(f"{self._lat_name}.client.{label}", total)
                if tel:
                    telemetry.emit(
                        EVENTS.SERVE_LATENCY_REQUEST, server=self.name,
                        label=label, rows=int(hi - lo), m=int(self.m),
                        queue_wait_s=round(queue_wait, 9),
                        serve_s=round(wall, 9), total_s=round(total, 9),
                        **({} if probes is None else {"probes": int(probes)}),
                    )
                lo = hi
            if recording():
                # the stamps already taken, on the profiler's clock
                off = perf_offset_ns()
                t0_ns = int(t0 * 1e9) + off
                for req in batch:
                    t_enq_ns = int(req[3] * 1e9) + off
                    record_span("rp:serve/queue_wait", t_enq_ns, t0_ns)

    def _run(self) -> None:
        device = getattr(self.index, "device", None)
        if device is not None and device.type == "cuda":
            import torch

            torch.cuda.set_device(device)
        draining = False
        while True:
            if draining:
                try:
                    first = self._q.get_nowait()
                except queue.Empty:
                    return
            else:
                first = self._q.get()
            if first is self._SENTINEL:
                draining = True  # serve what's already queued, then stop
                continue
            batch, saw_sentinel = self._collect(first)
            self._serve(batch)
            if saw_sentinel:
                draining = True


# -- CountSketch (config 5) ------------------------------------------------------------


class DeviceBatch:
    """A streaming CSR batch already laid out for the flat route and on its
    way to the device (``CountSketch.prepare_batch``): ``arrays`` are the
    tokens' ``(row, idx, val)`` device operands (on a card, each a
    ``StagedBatch`` still in flight on the copy stream), ``shape``/
    ``nbytes`` mirror the source batch so the stream's bookkeeping is
    unchanged."""

    __slots__ = ("arrays", "n", "shape", "nbytes")

    def __init__(self, arrays: tuple, n: int, shape: tuple, nbytes: int):
        self.arrays = arrays
        self.n = n
        self.shape = shape
        self.nbytes = nbytes


def _flat_layout(X):
    """The flat route's host layout of one CSR batch: each token's row,
    feature index and value, ``(nnz,)`` int32, int32 and float32 (the
    reference's ``_flat_mesh_layout(X, 1)`` without its row padding)."""
    rows = np.repeat(np.arange(X.shape[0], dtype=np.int32), np.diff(X.indptr))
    return (rows, X.indices.astype(np.int32, copy=False),
            X.data.astype(np.float32, copy=False))


def _flat_mesh_layout(X, p: int):
    """Token-balanced host layout of one CSR batch over ``p`` data shards
    (the reference's, bit for bit): rows partition at
    ``token_balanced_bounds`` cuts, so the padded token width ``t_pad``
    tracks ``nnz/p``; shards own unequal row ranges, each scatters into its
    own ``rows_blk``-row block (the bucketed most rows any shard owns), and
    ``perm`` maps the block-concatenated output back to global row order.
    Returns ``(rows_l, idx, vals, rows_blk, t_pad, perm)``, the first three
    ``(p, t_pad)`` (pad tokens carry value 0) and ``perm`` ``(n,)`` int32."""
    n = X.shape[0]
    indptr = X.indptr.astype(np.int64, copy=False)
    bounds_rows = token_balanced_bounds(indptr, p)
    tok_bounds = indptr[bounds_rows]
    rows_per = np.diff(bounds_rows)
    counts = np.diff(tok_bounds)
    rows_blk = row_bucket(int(max(rows_per.max(), 1)))
    t_pad = row_bucket(int(max(counts.max(), 1)))
    rows_l = np.zeros((p, t_pad), np.int32)
    idx_s = np.zeros((p, t_pad), np.int32)
    vals_s = np.zeros((p, t_pad), np.float32)
    row_sizes = np.diff(indptr)
    perm = np.empty(n, np.int64)
    for s in range(p):
        r0, r1 = int(bounds_rows[s]), int(bounds_rows[s + 1])
        lo, hi = int(tok_bounds[s]), int(tok_bounds[s + 1])
        c = hi - lo
        rows_l[s, :c] = np.repeat(
            np.arange(r1 - r0, dtype=np.int32), row_sizes[r0:r1]
        )
        idx_s[s, :c] = X.indices[lo:hi]
        vals_s[s, :c] = X.data[lo:hi]
        perm[r0:r1] = s * rows_blk + np.arange(r1 - r0)
    return rows_l, idx_s, vals_s, rows_blk, t_pad, perm.astype(np.int32)


class CountSketch(ParamsMixin):
    """Count-Sketch / hashing-trick projection ``(n, d) → (n, k)``.

    The hash map ``h_`` (int32 in ``[0, k)``) and signs ``s_`` (±1 int8)
    are drawn from the seed on the host exactly as the reference draws
    them (``SeedSequence([0x43534B31, seed])``), so both packages and every
    route compute the same sketch.

    ``backend='auto'``/``'torch'`` runs on the card (``backend_options=
    {'device': 'cpu'}`` on the CPU; with no card and no device the fit
    raises); ``'numpy'`` keeps every route on the host.  Routes:

    - dense float32: a one-hot ±1 matrix product (``M[h(j), j] = s(j)``,
      exact in bf16; x cut into three exact bf16 parts, float32 sums)
      while the mask fits ``_MXU_MASK_BYTES_CAP``, else a scatter-add
      (``index_add_``; ``use_mxu=False`` forces it, ``use_mxu=True``
      refuses anything else);
    - CSR float32: gather the resident tables at the tokens and
      scatter-add into the ``(n·k)`` output (``index_add_``, the flat
      route; the reference's doc-major compare-reduce took 18-34x its
      time on an H100 at 10, 100 and 1,000 tokens a doc,
      ``torch_experiments/countsketch_routes.py``);
    - float64 (dense or CSR) and every ``'numpy'`` batch: the host scatter,
      exact.

    On the card the scatter routes sum in the order the atomics land, so
    they agree with the host to float32 rounding, not bit for bit.

    ``mesh=`` (a ``parallel.Mesh`` of this process) row-shards the device
    routes over ``data_axis`` (DP, no collective, as the reference):
    dense rows split as ``parallel.sharded.Layout`` splits them, CSR
    batches at token-balanced row cuts (``_flat_mesh_layout``), each shard
    sketched on its device with its own tables, then gathered back to row
    order on the mesh's first device.
    """

    def __init__(self, n_components, *, random_state=None, backend="auto",
                 backend_options: Optional[dict] = None,
                 use_mxu: Optional[bool] = None, mesh=None,
                 data_axis: str = "data"):
        if not isinstance(n_components, numbers.Integral) or n_components <= 0:
            raise ValueError(
                f"n_components must be a positive int, got {n_components!r}"
            )
        self.n_components = int(n_components)
        self.random_state = random_state
        self.backend = backend
        self.backend_options = backend_options
        # None = the one-hot product when its mask fits the cap; False =
        # force the scatter; True = require the one-hot product
        self.use_mxu = use_mxu
        # DP row-sharding over a mesh (config 5 is a "100M docs on v5e-8"
        # workload): rows shard over data_axis, tables on every device
        self.mesh = mesh
        self.data_axis = data_axis

    def fit_schema(self, n_samples: int, n_features: int, dtype=np.float64):
        if n_features <= 0:
            raise ValueError(f"n_features must be strictly positive, got {n_features}")
        from randomprojection_tpu_torch.models.base import _resolve_seed

        self.seed_ = _resolve_seed(self.random_state)
        # a salted stream: a seed shared with the user's data generator
        # must not correlate h_/s_ with the data
        rng = np.random.default_rng(np.random.SeedSequence([0x43534B31, self.seed_]))
        self.n_components_ = self.n_components
        self.n_features_in_ = n_features
        self.h_ = rng.integers(0, self.n_components, size=n_features, dtype=np.int32)
        self.s_ = rng.integers(0, 2, size=n_features, dtype=np.int8) * 2 - 1
        self._resolve_execution()
        return self

    def _resolve_execution(self):
        """(Re)derive the device and drop the cached device tables; called
        at fit and whenever ``set_params`` touches an execution parameter."""
        from randomprojection_tpu_torch.backends.torch_backend import (
            resolve_device,
        )

        if self.backend not in ("auto", "torch", "numpy"):
            raise ValueError(
                f"backend must be 'auto', 'torch' or 'numpy', got {self.backend!r}"
            )
        opts = dict(self.backend_options or {})
        unknown = set(opts) - {"device"}
        if unknown:
            raise ValueError(
                f"CountSketch takes backend_options {{'device'}} only, got "
                f"{sorted(unknown)}"
            )
        if self.backend == "numpy":
            if self.use_mxu:
                raise ValueError(
                    "use_mxu=True requires the torch backend (backend="
                    f"'torch' or 'auto'), got backend={self.backend!r}"
                )
            self._device = None
        elif self.mesh is not None:
            from randomprojection_tpu_torch.parallel.mesh import Mesh

            if not isinstance(self.mesh, Mesh):
                raise ValueError(
                    "mesh must be a parallel.Mesh (make_mesh), got "
                    f"{self.mesh!r}")
            if "device" in opts:
                raise ValueError("pass backend_options={'device': ...} or "
                                 "mesh=, not both: a mesh names its devices")
            if self.mesh.ranks is not None:
                raise ValueError(
                    "CountSketch's mesh is this process's (make_mesh): DP "
                    "needs no collective, so a job of several processes "
                    "runs one sketch a process over its host_row_range")
            self._device = self.mesh.home()
        else:
            self._device = resolve_device(opts.get("device"))
        for key in ("_dev_tables", "_dev_mask"):
            self.__dict__.pop(key, None)

    @property
    def _use_device(self) -> bool:
        return self._device is not None

    def set_params(self, **params):
        super().set_params(**params)
        if {"use_mxu", "backend", "backend_options", "mesh",
                "data_axis"} & params.keys() and hasattr(self, "h_"):
            self._resolve_execution()
        return self

    def fit(self, X, y=None):
        X = check_array(X, accept_sparse=True)
        return self.fit_schema(*X.shape, dtype=X.dtype)

    def _check_is_fitted(self):
        if not hasattr(self, "h_"):
            raise NotFittedError(
                f"This {type(self).__name__} instance is not fitted yet."
            )

    def _check_width(self, X):
        if X.shape[1] != self.n_features_in_:
            raise ValueError(
                f"X has {X.shape[1]} features, expected {self.n_features_in_}"
            )

    def transform(self, X):
        """The sketch of one batch as a host array."""
        self._check_is_fitted()
        if sp.issparse(X):
            if self.use_mxu:
                raise ValueError(
                    "use_mxu=True cannot serve sparse input (the one-hot "
                    "product is dense-only); densify X or use use_mxu=None"
                )
            X = X.tocsr()
            self._check_width(X)
            if self._csr_on_device(X):
                return self._transform_csr_device(X).cpu().numpy()
            return self._transform_csr(X)
        X = check_array(X, accept_sparse=False)
        self._check_width(X)
        if self._use_device:
            y = self._transform_dense_device(X)
            return y if isinstance(y, np.ndarray) else y.cpu().numpy()
        return self._transform_dense_np(X)

    def fit_transform(self, X, y=None):
        return self.fit(X).transform(X)

    def _transform_dense_np(self, X):
        Y = np.zeros((X.shape[0], self.n_components_), dtype=X.dtype)
        np.add.at(Y, (slice(None), self.h_), X * self.s_)
        return Y

    # the one-hot mask's cap: past it (d = 2^20 at k = 256 would be 512 MiB
    # of bf16) the scatter wins on memory
    _MXU_MASK_BYTES_CAP = 64 << 20

    def _upload(self, a, device=None):
        """A host array on ``device`` (the sketch's), ready on the current
        stream (staged on the card's copy stream, ``ops.staging``)."""
        import torch

        from randomprojection_tpu_torch.ops.staging import stage_upload

        device = self._device if device is None else device
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cpu":
            return t
        return stage_upload(t, device).wait()

    def _device_tables(self, device=None):
        """``h_`` and ``s_`` (as float32) on ``device`` (the sketch's),
        uploaded once a fit and device."""
        device = self._device if device is None else device
        tables = self.__dict__.setdefault("_dev_tables", {})
        t = tables.get(str(device))
        if t is None:
            t = tables[str(device)] = (
                self._upload(self.h_, device),
                self._upload(self.s_.astype(np.float32), device))
        return t

    def _mxu_route(self) -> bool:
        """True when the dense float32 route is the one-hot product."""
        k, d = self.n_components_, self.n_features_in_
        fits_cap = 2 * k * d <= self._MXU_MASK_BYTES_CAP
        if self.use_mxu and not fits_cap:
            raise ValueError(
                f"use_mxu=True but the one-hot mask ({2 * k * d} bytes bf16) "
                f"exceeds the {self._MXU_MASK_BYTES_CAP}-byte cap; use "
                "use_mxu=None (auto) or False (scatter)"
            )
        return fits_cap if self.use_mxu is None else bool(self.use_mxu)

    def _onehot_mask(self, device=None):
        """``M (k, d)`` bf16 with ``M[h(j), j] = s(j)``, built on ``device``
        (the sketch's) once a fit and device."""
        import torch

        device = self._device if device is None else device
        masks = self.__dict__.setdefault("_dev_mask", {})
        m = masks.get(str(device))
        if m is None:
            h, s = self._device_tables(device)
            m = torch.zeros((self.n_components_, self.n_features_in_),
                            dtype=torch.float32, device=device)
            m[h.long(), torch.arange(self.n_features_in_, device=device)] = s
            m = masks[str(device)] = m.to(torch.bfloat16)
        return m

    def _sketch_dense(self, x):
        """The dense float32 sketch of ``x`` on its device: the one-hot
        product or the scatter."""
        import torch

        from randomprojection_tpu_torch.ops.precision import mm_f32acc
        from randomprojection_tpu_torch.ops.split_matmul import (
            split_f32_to_bf16_triple,
        )

        if self._mxu_route():
            mt = self._onehot_mask(x.device).t()
            # three exact bf16 parts: each product with ±1 is exact, the
            # sums are float32
            return sum(mm_f32acc(p, mt) for p in split_f32_to_bf16_triple(x))
        h, s = self._device_tables(x.device)
        y = torch.zeros((x.shape[0], self.n_components_), dtype=torch.float32,
                        device=x.device)
        return y.index_add_(1, h, x * s)

    def _transform_dense_device(self, X):
        """Dense rows on the device: float64 (and other non-float32 dtypes)
        stay on the host, exact; float32 runs the one-hot product or the
        scatter, under a mesh each row block on its device.  Returns a
        device tensor (or the host array)."""
        if X.dtype != np.float32:
            if self.use_mxu:
                raise ValueError(
                    f"use_mxu=True cannot serve {X.dtype} input (the one-hot "
                    "product runs in float32); cast X to float32 or use "
                    "use_mxu=None"
                )
            return self._transform_dense_np(X)
        x = self._upload(X)
        if self.mesh is None:
            return self._sketch_dense(x)
        from randomprojection_tpu_torch.parallel.sharded import run_sharded

        return run_sharded(self.mesh, x, self.n_components_,
                           lambda pos, xb, out: self._sketch_dense(xb),
                           data_axis=self.data_axis)

    def _csr_on_device(self, X) -> bool:
        """Device CSR eligibility: the torch backend, float32 data (float64
        stays on the host, exact) and a flat output index that fits int32,
        as the reference's gate: ``n·k`` rows, and under a mesh the row
        bucket (the token-balanced cuts may hand one shard every row)."""
        n = (X.shape[0] if self.mesh is None
             else row_bucket(max(X.shape[0], 1), self.mesh, self.data_axis))
        return (self._use_device and X.dtype == np.float32
                and n * self.n_components_ < 2**31)

    def _flat_dispatch(self, rows_dev, idx_dev, vals_dev, n: int):
        """Gather the tables resident on the tokens' device, scatter-add
        into the flat ``(n·k)`` accumulator (``index_add_``)."""
        import torch

        k = self.n_components_
        h, s = self._device_tables(rows_dev.device)
        flat = rows_dev.long() * k + h.index_select(0, idx_dev)
        y = torch.zeros(n * k, dtype=torch.float32, device=rows_dev.device)
        y.index_add_(0, flat, vals_dev * s.index_select(0, idx_dev))
        return y.reshape(n, k)

    def _transform_csr_device(self, X):
        """Sketch a float32 CSR batch on the device (config 5's hot loop):
        per batch only the tokens' ``(row, idx, val)`` cross, the
        2^20-wide input never materializes, and the tables stay resident.
        Under a mesh each data shard sketches its token-balanced row range
        into its own row block on its device, and one gather (``perm``)
        restores row order on the sketch's device.  Returns a device
        tensor."""
        if self.mesh is None:
            return self._flat_dispatch(*map(self._upload, _flat_layout(X)),
                                       X.shape[0])
        import torch

        from randomprojection_tpu_torch.parallel.mesh import data_axis_devices

        devices = data_axis_devices(self.mesh, self.data_axis)
        rows_l, idx_s, vals_s, rows_blk, _, perm = _flat_mesh_layout(
            X, len(devices))
        # only each shard's real tokens go up: its padding adds zeros
        counts = np.diff(X.indptr[token_balanced_bounds(X.indptr,
                                                        len(devices))])
        blocks = [
            self._flat_dispatch(
                *(self._upload(a[s, :c], dev) for a in (rows_l, idx_s, vals_s)),
                rows_blk).to(self._device)
            for s, (dev, c) in enumerate(zip(devices, counts))
        ]
        return torch.cat(blocks).index_select(
            0, self._upload(perm.astype(np.int64)))

    def _transform_csr(self, X):
        """The host scatter (float64 and the numpy backend): exact."""
        self._check_width(X)
        out_dtype = X.dtype if X.dtype in (np.float32, np.float64) else np.float64
        Y = np.zeros((X.shape[0], self.n_components_), dtype=out_dtype)
        rows = np.repeat(np.arange(X.shape[0]), np.diff(X.indptr).astype(np.int64))
        np.add.at(Y, (rows, self.h_[X.indices]),
                  X.data.astype(out_dtype) * self.s_[X.indices])
        return Y

    # -- streaming (the protocol of BaseRandomProjection) ------------------------

    def fit_source(self, source):
        n_rows, n_features, dtype = source.schema()
        return self.fit_schema(n_rows, n_features, dtype=dtype)

    def transform_stream(self, source, **kwargs):
        from randomprojection_tpu_torch.streaming import stream_transform

        return stream_transform(self, source, **kwargs)

    def prepare_batch(self, X):
        """Lay a CSR batch out for its device route and start its upload,
        so the dispatch only launches.  Safe from a worker thread: on a
        card each operand goes up on the card's copy stream with an event
        behind it (``ops.staging.stage_upload``), and the
        dispatch makes its stream wait for them.  Batches the device CSR
        routes do not serve, and every batch under a mesh (laid out at
        dispatch, as the reference does), are returned unchanged."""
        self._check_is_fitted()
        if not sp.issparse(X) or self.use_mxu or self.mesh is not None:
            # a mesh lays the batch out at dispatch
            return X
        X = X.tocsr()
        self._check_width(X)
        if not self._csr_on_device(X):
            return X
        nbytes = int(X.data.nbytes + X.indices.nbytes + X.indptr.nbytes)
        layout = _flat_layout(X)
        if self._device.type == "cpu":
            arrays = tuple(map(self._upload, layout))
        else:
            import torch

            from randomprojection_tpu_torch.ops.staging import stage_upload
            from randomprojection_tpu_torch.utils.observability import (
                annotate,
            )

            with annotate("rp:stream/h2d_prefetch"):
                arrays = tuple(stage_upload(torch.from_numpy(a), self._device)
                               for a in layout)
        return DeviceBatch(arrays, X.shape[0], X.shape, nbytes)

    def _transform_async(self, X):
        """The stream's transform: a device tensor still being computed on
        the device routes (``stream_transform`` copies it to the host
        behind its kernels), a host array on the host routes.  Takes
        ``DeviceBatch``es from ``prepare_batch``."""
        self._check_is_fitted()
        if isinstance(X, DeviceBatch):
            arrays = tuple(a if self._device.type == "cpu" else a.wait()
                           for a in X.arrays)
            return self._flat_dispatch(*arrays, X.n)
        if sp.issparse(X):
            X = X.tocsr()
            self._check_width(X)
            if not self.use_mxu and self._csr_on_device(X):
                return self._transform_csr_device(X)
            return self.transform(X)
        X = check_array(X, accept_sparse=False)
        self._check_width(X)
        if self._use_device:
            return self._transform_dense_device(X)
        return self._transform_dense_np(X)

    def _stream_out_dtype(self):
        return None  # keep the dtype the route produced

    def _stream_out_width(self) -> int:
        return self.n_components_

    def get_feature_names_out(self, input_features=None):
        """Output names ``countsketch<i>``."""
        self._check_is_fitted()
        return np.asarray([f"countsketch{i}" for i in range(self.n_components_)],
                          dtype=object)

    def inverse_transform(self, Y):
        """Unbiased decode: ``x̂[j] = s(j) · Y[:, h(j)]``."""
        self._check_is_fitted()
        Y = np.asarray(Y)
        if Y.shape[1] != self.n_components_:
            raise ValueError(
                f"Y has {Y.shape[1]} components, expected {self.n_components_}"
            )
        return Y[:, self.h_] * self.s_
