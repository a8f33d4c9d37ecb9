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
version serves.  Meshes (ROADMAP A10), tiered residency (A12) and
snapshots (A9) are later slices and raise naming their item.  The
multi-probe LSH tier on top of the index is ``ann.LSHSimHashIndex``; a
``TopKServer`` takes per-label probe budgets for it (``probe_policy``).
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

from randomprojection_tpu_torch.models.base import BaseRandomProjection
from randomprojection_tpu_torch.ops import topk_kernels
from randomprojection_tpu_torch.parallel.sharded import row_bucket
# a tensor's copy to the host: pinned memory, non_blocking, an event
# behind it on a card; .result(None) waits for that copy alone
from randomprojection_tpu_torch.streaming import _HostFetch
from randomprojection_tpu_torch.utils import telemetry
from randomprojection_tpu_torch.utils.telemetry import EVENTS

__all__ = [
    "SignRandomProjection",
    "SimHashIndex",
    "TopKServer",
    "pairwise_hamming",
    "pairwise_hamming_device",
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

    Thread-safety: queries may run concurrently with each other, but
    mutation (``add``/``delete``/``compact``) requires the index to be
    quiescent — drain a ``TopKServer`` before compacting.
    """

    def __init__(self, codes, *, mesh=None, n_bits: Optional[int] = None,
                 device=None,
                 label: Optional[str] = None,
                 hbm_budget_bytes: Optional[int] = None,
                 cold_tier: str = "host", cold_dir: Optional[str] = None):
        from randomprojection_tpu_torch.backends.torch_backend import (
            resolve_device,
        )

        for name, value, default, item in (
            ("mesh", mesh, None, "A10 (scale-out)"),
            ("hbm_budget_bytes", hbm_budget_bytes, None,
             "A12 (tiered residency)"),
            ("cold_tier", cold_tier, "host", "A12 (tiered residency)"),
            ("cold_dir", cold_dir, None, "A12 (tiered residency)"),
        ):
            if value != default:
                raise ValueError(
                    f"{name}={value!r} is not ported yet (ROADMAP {item}); "
                    f"SimHashIndex takes {name}={default!r} only"
                )
        self.device = resolve_device(device, how="device='cpu'")
        if self.device.type == "cuda" and self.device.index is None:
            import torch

            # a concrete card, so the server's thread can pin it
            self.device = torch.device("cuda", torch.cuda.current_device())
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

    def _to_device(self, a):
        """One host array or tensor onto the index's device: host arrays
        are copied (through pinned memory and a ``non_blocking`` copy on a
        card), a tensor already on the device is kept as it is."""
        import torch

        if isinstance(a, torch.Tensor):
            return a.to(self.device).contiguous()
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cpu":
            return t.clone()
        return t.pin_memory().to(self.device, non_blocking=True)

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
                "Grow past int32 by sharding over more devices"
            )
        self._chunks.append(_IndexChunk(self._to_device(codes), n, self.n_codes))
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
            self._to_device(sl.astype(np.uint8)) if sl.any() else None
        )
        chunk.dead_rev = self._dead_rev
        return chunk.dead_dev

    def compact(self) -> np.ndarray:
        """Fold tombstones and merge every chunk into ONE resident chunk;
        returns the old global ids of the surviving codes in their new id
        order (``new id i`` was ``mapping[i]``).  A host rebuild and one
        full re-upload: a maintenance operation, not a serving one, and
        not safe under concurrent queries."""
        parts = [c.b.cpu().numpy() for c in self._chunks]
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

    def _rebuild_from_host(self, codes: np.ndarray) -> None:
        """Replace every resident chunk with ONE chunk holding ``codes``
        (the live code set in id order) and clear the tombstones."""
        old_n, old_chunks = self.n_codes, len(self._chunks)
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

    def save(self, path: str):
        raise ValueError("SimHashIndex.save is not ported yet (ROADMAP A9, durable.py)")

    @classmethod
    def load(cls, path: str, **kwargs):
        raise ValueError("SimHashIndex.load is not ported yet (ROADMAP A9, durable.py)")

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
        pending: list = []  # [(lo, hi, [per-chunk host fetches])]

        def finish(entry):
            lo, hi, fetches = entry
            for c, f in zip(self._chunks, fetches):
                out[lo:hi, c.row0: c.row0 + c.n] = f.result(None)

        for lo in range(0, A.shape[0], tile):
            hi = min(lo + tile, A.shape[0])
            a = self._to_device(A[lo:hi])
            pending.append((lo, hi, [_HostFetch(topk_kernels.hamming_counts(a, c.b))
                                     for c in self._chunks]))
            telemetry.registry().counter_inc(
                "simhash.chunk_dispatches", len(self._chunks)
            )
            if telemetry.enabled():
                telemetry.emit(
                    EVENTS.SIMHASH_QUERY_TILE, queries=int(hi - lo),
                    chunks=len(self._chunks), n_codes=self.n_codes,
                )
            if len(pending) >= 2:
                finish(pending.pop(0))
        while pending:
            finish(pending.pop(0))
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
        index serves any ``m`` with the kernel's plain version."""
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
        # m_eff counts LIVE codes only: tombstoned rows never win, and the
        # result width never includes sentinel filler
        m_eff = int(min(m, self.n_live))
        if self.device.type == "cuda" and m_eff > topk_kernels.MAX_M:
            raise ValueError(
                f"query_topk m={m_eff} exceeds the kernel's largest m "
                f"(MAX_M={topk_kernels.MAX_M}) for an index on {self.device}"
            )
        nq = A.shape[0]
        out_d = np.empty((nq, m_eff), dtype=np.int32)
        out_i = np.empty((nq, m_eff), dtype=np.int32)
        # tiles finish one behind: tile i's copy to the host and its merge
        # ride under tile i+1's kernels
        pending: list = []

        def finish(entry):
            lo, hi, handles = entry
            out_d[lo:hi], out_i[lo:hi] = self._topk_finish_tile(handles, m_eff)

        for lo in range(0, nq, tile):
            hi = min(lo + tile, nq)
            pending.append(
                (lo, hi, self._topk_dispatch_tile(A[lo:hi], m_eff))
            )
            if len(pending) >= 2:
                finish(pending.pop(0))
        while pending:
            finish(pending.pop(0))
        return out_d, out_i

    # -- tile-level dispatch/finish halves (shared with the sharded tier) ------

    def _topk_dispatch_tile(self, a_np, m_eff: int) -> list:
        """Dispatch one query tile against every resident chunk and start
        each result's copy to the host; returns the per-chunk
        ``(dist, idx)`` fetches for ``_topk_finish_tile``."""
        a = self._to_device(a_np)
        handles = []
        for c in self._chunks:
            d, i = self._chunk_topk(a, c, int(min(m_eff, c.n)))
            handles.append((_HostFetch(d), _HostFetch(i)))
        telemetry.registry().counter_inc(
            "simhash.chunk_dispatches", len(self._chunks)
        )
        if telemetry.enabled():
            telemetry.emit(
                EVENTS.SIMHASH_TOPK_TILE, queries=int(a_np.shape[0]),
                m=int(m_eff), chunks=len(self._chunks), n_codes=self.n_codes,
            )
        return handles

    def _topk_finish_tile(self, handles: list, m_eff: int):
        """Wait for one tile's per-chunk candidates and merge them across
        chunks under the (distance, lower-id) total order.  Returns
        ``(dist, idx)`` host arrays, each ``(tile_rows, m_eff)`` int32."""
        # distances fit 25 bits and ids int32, so (dist << shift) | id is
        # an exact int64 total-order key
        shift = max(self.n_codes.bit_length(), 1)
        cand_d, cand_i = [], []
        for c, (d, i) in zip(self._chunks, handles):
            cand_d.append(d.result(None))
            cand_i.append(i.result(None).astype(np.int64) + c.row0)
        d = np.concatenate(cand_d, axis=1)
        i = np.concatenate(cand_i, axis=1)
        # clamp sentinel ids (empty slots carry id 2^31-1) so they cannot
        # bleed into the dist bits of the key; their sentinel dist
        # already orders them last
        key = (d.astype(np.int64) << shift) | np.minimum(i, (1 << shift) - 1)
        sel = np.argsort(key, axis=1, kind="stable")[:, :m_eff]
        return (
            np.take_along_axis(d, sel, axis=1),
            np.take_along_axis(i, sel, axis=1).astype(np.int32),
        )

    def _chunk_topk(self, a, chunk, m_c: int):
        """Device top-``m_c`` of one chunk for one query tile: ``(dist,
        local_idx)``, each ``(t, m_c)`` int32, from the fused top-k
        kernel (its plain version on the CPU).  Pad and tombstoned rows
        never enter the selection; a chunk with no deletions runs the
        unmasked variant."""
        dead = self._chunk_dead_device(chunk)
        d, i = topk_kernels.fused_topk(a, chunk.b, chunk.n, m_c, dead=dead)
        if telemetry.enabled():
            telemetry.emit(
                EVENTS.TOPK_KERNEL_DISPATCH, queries=int(a.shape[0]),
                m=int(m_c), rows=int(chunk.n), masked=dead is not None,
            )
        return d, i


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
        # dispatcher-thread-private tallies, read by stats()
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
            # never blocks: submit() keeps at most max_pending requests
            # queued under this lock, so the sentinel's slot is free
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
        traffic (``probes=None``) keeps the index's own default."""
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
        t0 = time.perf_counter()
        kw = {} if probes is None else {"probes": probes}
        try:
            d, i = self.index.query_topk(arr, self.m, tile=pad_to, **kw)
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
        reg.counter_inc("serve.topk.requests", len(batch))
        reg.counter_inc("serve.topk.queries", n)
        reg.gauge_set("serve.topk.batch_rows", n)
        tel = telemetry.enabled()
        if tel:
            telemetry.emit(
                EVENTS.SERVE_TOPK_BATCH, rows=int(n), padded=int(pad_to),
                requests=len(batch), m=int(self.m), wall_s=round(wall, 6),
                **kw,
            )
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
                )
            lo = hi

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
