"""Durable index lifecycle: snapshot/restore + exactly-once crash recovery.

The port of ``randomprojection_tpu/durable.py``, in its on-disk format: a
snapshot written by either package loads in the other, and ``query_topk``
answers bit for bit.

- **Snapshot format** — ``save_index``/``load_index`` spill an index's
  packed-code chunks to per-chunk ``.npy`` files under a directory,
  described by a versioned ``manifest.json`` carrying per-chunk SHA-256
  payload checksums (and the little-endian tombstone bitmap, when any).
  Every file is written write-tmp → fsync → ``os.replace``, the manifest
  is committed LAST (after a directory fsync, and followed by one), and
  chunk files are generation-numbered, so a rewrite never touches a file
  the committed manifest references.  Readers reject unknown format
  versions and verify every checksum before upload.
- **Durable ingest** — ``DurableIngest`` binds ``stream_transform``'s
  cursor to the snapshot: each consumed batch appends one chunk file, and
  the cursor commit (``rows_done``) and the chunk flush are ONE atomic
  manifest replace.  A run resumed after a ``kill -9`` replays exactly the
  uncommitted row ranges, and the rebuilt index is bit-identical to an
  uninterrupted run.
- **Fault harness** — kill points (``RP_DURABLE_KILL=<point>@<n>``
  delivers an uncatchable SIGKILL at the n-th hit), the subprocess child
  ``python -m randomprojection_tpu_torch.durable --child <dir> ...
  [--device cpu]`` (the card unless asked) and ``crash_smoke``, which
  runs the kill matrix, restarts each crashed run and holds the result to
  a clean run.

Tiered indexes: ``save_index`` writes the index's ``tier`` block (its
budget, cold tier and each chunk's residency at snapshot time; the
payload is residency-independent), ``verify_snapshot`` reports it, and
``load_index(index_kwargs={'hbm_budget_bytes': ...})`` re-tiers the
restored chunks under the caller's budget.  The fourth kill point,
``mid-demotion``, is in the tier's demotion (``tiering.py``), between the
spill write and the residency swap; the harness child crosses it in a
disk-tiered leg after its ingest.

Sharded indexes: ``save_sharded_index`` writes a
``serving.ShardedSimHashIndex`` in global id order (the plain format plus
``sharded.shards`` and, when nonzero, ``id_offset``), and
``load_sharded_index`` restores any snapshot onto any shard layout;
``load_index`` restores a snapshot with no ``id_offset`` as a plain index
(on one device, or row-sharded over ``mesh``) and points an ``id_offset``
manifest to ``load_sharded_index``.

Telemetry: ``index.snapshot.save``/``index.snapshot.load``,
``recover.resume``, ``recover.orphan_chunk`` and
``recover.checksum_mismatch``.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import re
import signal
import subprocess
import sys
from typing import Optional

import numpy as np

from randomprojection_tpu_torch.streaming import (
    StreamCursor,
    _fsync_dir,
    stream_transform,
)
from randomprojection_tpu_torch.utils import telemetry
from randomprojection_tpu_torch.utils.telemetry import EVENTS

__all__ = [
    "INDEX_FORMAT_VERSION",
    "MANIFEST_NAME",
    "KILL_POINTS",
    "KILL_ENV",
    "DurableIngest",
    "save_index",
    "load_index",
    "save_sharded_index",
    "load_sharded_index",
    "read_manifest",
    "verify_snapshot",
    "check_coverage",
    "demo_ingest",
    "run_child",
    "crash_smoke",
]

INDEX_FORMAT_VERSION = 1
MANIFEST_NAME = "manifest.json"

# fault-injection points, in pipeline order; RP_DURABLE_KILL="<point>@<n>"
# SIGKILLs the process the n-th time that point is reached.  The last one
# is in the tier's demotion (tiering.py): the cold spill file exists but
# the residency swap has not happened
KILL_POINTS = ("mid-batch", "post-yield-pre-ack", "mid-snapshot-rename",
               "mid-demotion")
KILL_ENV = "RP_DURABLE_KILL"
_kill_counts: dict = {}



def _maybe_kill(point: str) -> None:
    """Fault-injection hook: if ``RP_DURABLE_KILL=<point>@<n>`` names
    this point, deliver an uncatchable SIGKILL on its n-th hit — no
    cleanup, no atexit, no flushing: exactly a ``kill -9``."""
    spec = os.environ.get(KILL_ENV)
    if not spec:
        return
    want, _, nth = spec.partition("@")
    if want != point:
        return
    _kill_counts[point] = _kill_counts.get(point, 0) + 1
    if _kill_counts[point] >= int(nth or 1):
        os.kill(os.getpid(), signal.SIGKILL)  # pragma: no cover — dies


def _sha256(arr: np.ndarray) -> str:
    """Payload checksum over the raw row bytes, not the .npy container."""
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _write_npy_atomic(path: str, arr: np.ndarray) -> None:
    """Crash-safe array spill: write-tmp → flush → fsync → ``os.replace``."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.save(f, arr)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _commit_manifest(dirpath: str, manifest: dict) -> None:
    """THE commit point: one atomic ``os.replace`` of ``manifest.json``.
    The directory fsync before it makes the spills' renames durable
    before a manifest can name them; the one after makes the manifest's
    own rename durable."""
    _fsync_dir(dirpath)
    path = os.path.join(dirpath, MANIFEST_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    _maybe_kill("mid-snapshot-rename")
    os.replace(tmp, path)
    _fsync_dir(dirpath)


def _next_generation_from_files(dirpath: str) -> int:
    """Smallest generation past every spill already on disk (no readable
    manifest records one), so a new snapshot never overwrites a file."""
    gen = -1
    for fn in os.listdir(dirpath):
        m = re.match(r"(?:chunk|tombstones|lsh)-(\d{6})", fn)
        if m:
            gen = max(gen, int(m.group(1)))
    return gen + 1


def _spill_chunk(dirpath: str, gen: int, seq: int, arr: np.ndarray,
                 row0: int) -> dict:
    """Write one chunk spill under its generation-numbered name and
    return its manifest entry (save, ingest commit and compaction all
    spill through here)."""
    fname = f"chunk-{gen:06d}-{seq:08d}.npy"
    _write_npy_atomic(os.path.join(dirpath, fname), arr)
    return {
        "file": fname, "rows": int(arr.shape[0]), "row0": int(row0),
        "sha256": _sha256(arr),
    }


def read_manifest(dirpath: str) -> dict:
    """Load and validate a snapshot manifest; unknown format versions
    (and non-index manifests) are rejected."""
    path = os.path.join(dirpath, MANIFEST_NAME)
    with open(path) as f:
        m = json.load(f)
    version = m.get("format_version")
    if version != INDEX_FORMAT_VERSION:
        raise ValueError(
            f"Unsupported index manifest version {version!r} in {path} "
            f"(expected {INDEX_FORMAT_VERSION})"
        )
    if m.get("kind") != "simhash_index":
        raise ValueError(
            f"{path} is not a SimHash index manifest "
            f"(kind={m.get('kind')!r})"
        )
    return m


def check_coverage(manifest: dict) -> int:
    """Assert the chunks' row ranges tile ``[0, n_codes)`` exactly once, in
    order (no dropped or double-committed batch).  Returns the covered row
    count; raises ``ValueError`` on any gap or overlap."""
    pos = 0
    for entry in manifest["chunks"]:
        if entry["row0"] != pos:
            raise ValueError(
                f"chunk {entry['file']} starts at row {entry['row0']}, "
                f"expected {pos}: row ranges must tile without gaps or "
                "overlaps (a dropped or double-committed batch)"
            )
        pos += entry["rows"]
    if pos != manifest["n_codes"]:
        raise ValueError(
            f"chunks cover {pos} rows but the manifest records "
            f"n_codes={manifest['n_codes']}"
        )
    return pos


def _estimator_fingerprint(est) -> dict:
    """The class plus the full spec (seed included): recorded in the
    ingest manifest so a resume with another projection is refused."""
    fp = {"class": type(est).__name__}
    spec = getattr(est, "spec_", None)
    if spec is not None:
        fp["spec"] = spec.to_dict()
    elif hasattr(est, "seed_"):
        fp["seed"] = int(est.seed_)
    return fp


def _referenced_files(manifest: dict) -> set:
    refs = {e["file"] for e in manifest["chunks"]}
    for extra in ("tombstones", "lsh"):
        if manifest.get(extra):
            refs.add(manifest[extra]["file"])
    return refs


def _scan_orphans(dirpath: str, manifest: Optional[dict]) -> list:
    """Spill files in the directory that the committed manifest does not
    reference (a crash between a flush and its commit), plus any ``.tmp``."""
    refs = _referenced_files(manifest) if manifest else set()
    orphans = []
    for fn in sorted(os.listdir(dirpath)):
        if fn.endswith(".tmp") or (
            fn.endswith(".npy")
            and fn.startswith(("chunk-", "tombstones-", "lsh-"))
            and fn not in refs
        ):
            orphans.append(fn)
    return orphans


def _load_chunk_verified(dirpath: str, entry: dict) -> np.ndarray:
    """Read one spill file and verify it against its manifest entry;
    corruption raises ``ValueError`` and emits
    ``recover.checksum_mismatch``."""
    path = os.path.join(dirpath, entry["file"])
    try:
        arr = np.load(path)
    except (OSError, ValueError) as e:
        telemetry.emit(
            EVENTS.RECOVER_CHECKSUM_MISMATCH, file=entry["file"],
            error=repr(e),
        )
        raise ValueError(
            f"snapshot chunk {path} is unreadable ({e}); the manifest "
            "references it — the snapshot is corrupt"
        ) from e
    actual = _sha256(arr)
    if actual != entry["sha256"]:
        telemetry.emit(
            EVENTS.RECOVER_CHECKSUM_MISMATCH, file=entry["file"],
            expected=entry["sha256"], actual=actual,
        )
        raise ValueError(
            f"snapshot chunk {path} fails checksum verification "
            f"(expected sha256 {entry['sha256'][:16]}…, got "
            f"{actual[:16]}…); refusing to load a corrupt index"
        )
    return arr


def _verified_chunks(dirpath: str, manifest: dict):
    """The manifest's chunks in order, each checksum-verified and held to
    its ``(rows, n_bytes)``."""
    for entry in manifest["chunks"]:
        arr = _load_chunk_verified(dirpath, entry)
        if arr.ndim != 2 or arr.shape != (entry["rows"], manifest["n_bytes"]):
            raise ValueError(
                f"snapshot chunk {entry['file']} has shape {arr.shape}, "
                f"manifest says ({entry['rows']}, {manifest['n_bytes']})"
            )
        yield arr


def _next_generation(dirpath: str) -> int:
    try:
        return read_manifest(dirpath).get("generation", 0) + 1
    except FileNotFoundError:
        pass
    except ValueError:
        # a corrupt or unknown-version manifest must not block the repair
        # (re-save), but the generation must pass every spill on disk
        pass
    return _next_generation_from_files(dirpath)


def save_index(index, dirpath: str, *, ingest: Optional[dict] = None) -> dict:
    """Write a durable snapshot of a ``SimHashIndex`` under ``dirpath``.

    One ``.npy`` spill per resident chunk (one ``.cpu()`` copy each; chunk
    structure round-trips) plus the tombstone bitmap, then one atomic
    manifest commit; the previous generation's files are unlinked only
    after it.  ``ingest`` attaches the durable-ingest cursor binding.
    Returns the committed manifest."""
    os.makedirs(dirpath, exist_ok=True)
    gen = _next_generation(dirpath)
    entries = [
        _spill_chunk(dirpath, gen, i, index._fetch_chunk_host(chunk),
                     chunk.row0)
        for i, chunk in enumerate(index._chunks)
    ]
    tomb = None
    if index.n_deleted:
        packed = np.packbits(index._dead, bitorder="little")
        fname = f"tombstones-{gen:06d}.npy"
        _write_npy_atomic(os.path.join(dirpath, fname), packed)
        tomb = {
            "file": fname, "deleted": int(index.n_deleted),
            "sha256": _sha256(packed),
        }
    manifest = {
        "format_version": INDEX_FORMAT_VERSION,
        "kind": "simhash_index",
        "n_bytes": int(index.n_bytes),
        "n_bits": int(index.n_bits),
        "n_codes": int(index.n_codes),
        "generation": gen,
        "chunks": entries,
        "tombstones": tomb,
    }
    if ingest is not None:
        manifest["ingest"] = ingest
    # index-class extras (the LSH tier spills its band keys), written
    # before the commit: a crash leaves them as orphans for the sweep
    extra_hook = getattr(index, "_durable_extra", None)
    if extra_hook is not None:
        manifest.update(extra_hook(dirpath, gen))
    # a tiered index's residency at snapshot time: provenance and a
    # verification surface (the spills above read hot and cold chunks
    # alike), never a load-time requirement
    tier = getattr(index, "_tier", None)
    if tier is not None:
        manifest.update(tier.manifest_block())
    _commit_manifest(dirpath, manifest)
    for fn in _scan_orphans(dirpath, manifest):
        os.unlink(os.path.join(dirpath, fn))
    telemetry.emit(
        EVENTS.INDEX_SNAPSHOT_SAVE, path=dirpath, generation=gen,
        chunks=len(entries), n_codes=int(index.n_codes),
        deleted=int(index.n_deleted),
        **({"rows_done": ingest["rows_done"]} if ingest else {}),
    )
    return manifest


def _check_tier_block(manifest: dict) -> None:
    """Validate a manifest's tiered-residency block as the reference does
    (no-op when absent); unknown formats or tags raise ``ValueError``."""
    from randomprojection_tpu_torch.tiering import COLD_TIERS

    block = manifest.get("tier")
    if block is None:
        return
    if block.get("format") != 1:
        raise ValueError(
            f"unknown tier-block format {block.get('format')!r} "
            "(this reader understands format 1)"
        )
    if block.get("cold_tier") not in COLD_TIERS:
        raise ValueError(
            f"unknown cold_tier {block.get('cold_tier')!r} in tier "
            f"block (expected one of {COLD_TIERS})"
        )
    known = ("hot",) + COLD_TIERS
    rows_by_tag = {e["row0"]: e["rows"] for e in manifest["chunks"]}
    for entry in block.get("chunks", []):
        if entry.get("tier") not in known:
            raise ValueError(
                f"unknown residency tag {entry.get('tier')!r} for chunk "
                f"row0={entry.get('row0')} (expected one of {known})"
            )
        if rows_by_tag.get(entry.get("row0")) != entry.get("rows"):
            raise ValueError(
                f"tier block names chunk row0={entry.get('row0')} "
                f"rows={entry.get('rows')} but the manifest's chunk "
                "table disagrees"
            )


def load_index(dirpath: str, *, device=None, mesh=None,
               data_axis: str = "data", index_cls=None,
               index_kwargs: Optional[dict] = None):
    """Rebuild a ``SimHashIndex`` from a snapshot directory on ``device``
    (None: the card), or row-sharded over ``mesh``'s ``data_axis``.

    The manifest's format version is checked first, every chunk payload
    is SHA-256-verified before upload, chunk structure and global ids are
    restored exactly, and the tombstone bitmap (if any) is re-armed.  A
    snapshot of the sharded tier (global id order) loads here as a plain
    index with the same answers; one with an ``id_offset`` refuses and
    points to ``load_sharded_index``, which restores the offset.  A tier
    block is validated; the restored index tiers under ``index_kwargs``'
    ``hbm_budget_bytes`` (and ``cold_tier``/``cold_dir``) when given, and
    is fully resident otherwise.  ``index_cls`` restores a subclass
    instead (the LSH tier; ``ann.load_lsh_index`` is its public face)."""
    from randomprojection_tpu_torch.models.sketch import SimHashIndex

    manifest = read_manifest(dirpath)
    check_coverage(manifest)
    _check_tier_block(manifest)
    if manifest.get("id_offset"):
        # a plain index has no id offset: loading would renumber the
        # corpus from 0
        raise ValueError(
            f"{dirpath} was saved with id_offset="
            f"{manifest['id_offset']} (a sharded-tier global id space); "
            "load it with ShardedSimHashIndex.load / "
            "durable.load_sharded_index, which restores the offset"
        )
    cls = SimHashIndex if index_cls is None else index_cls
    kw = dict(index_kwargs or {})
    if mesh is not None:
        kw.update(mesh=mesh, data_axis=data_axis)
    index = cls(
        np.empty((0, manifest["n_bytes"]), np.uint8),
        n_bits=manifest["n_bits"], device=device, **kw,
    )
    for arr in _verified_chunks(dirpath, manifest):
        index.add(arr)
    if index.n_codes != manifest["n_codes"]:
        raise ValueError(
            f"restored {index.n_codes} codes but the manifest records "
            f"{manifest['n_codes']}"
        )
    tomb = manifest.get("tombstones")
    if tomb:
        packed = _load_chunk_verified(dirpath, tomb)
        dead = np.unpackbits(
            packed, count=manifest["n_codes"], bitorder="little"
        ).astype(bool)
        if int(dead.sum()) != tomb["deleted"]:
            raise ValueError(
                f"tombstone bitmap in {dirpath} marks {int(dead.sum())} "
                f"codes deleted but the manifest records {tomb['deleted']}"
            )
        index._restore_tombstones(dead)
    telemetry.emit(
        EVENTS.INDEX_SNAPSHOT_LOAD, path=dirpath,
        generation=manifest["generation"], chunks=len(manifest["chunks"]),
        n_codes=int(index.n_codes), deleted=int(index.n_deleted),
    )
    return index


def save_sharded_index(index, dirpath: str) -> dict:
    """Durable snapshot of a ``serving.ShardedSimHashIndex``, agnostic of
    its layout: one spill a segment (a shard's chunk) in global id order,
    so the files are a plain index snapshot of the concatenated corpus
    (same manifest kind, coverage and checksums) plus ``sharded`` (the
    writing layout) and ``id_offset`` (when nonzero).  It restores under
    any shard count (``load_sharded_index``), or as a plain
    ``SimHashIndex`` when ``id_offset`` is 0 (``load_index``), in either
    package, with the same answers.  The commit discipline is
    ``save_index``'s; the tombstones persist as the global bitmap.
    Returns the committed manifest."""
    os.makedirs(dirpath, exist_ok=True)
    gen = _next_generation(dirpath)
    entries = [
        _spill_chunk(dirpath, gen, seq, rows, g0)
        for seq, (g0, rows) in enumerate(index._iter_segment_host())
    ]
    tomb = None
    dead = index._dead_global()
    if dead is not None:
        packed = np.packbits(dead, bitorder="little")
        fname = f"tombstones-{gen:06d}.npy"
        _write_npy_atomic(os.path.join(dirpath, fname), packed)
        tomb = {
            "file": fname, "deleted": int(index.n_deleted),
            "sha256": _sha256(packed),
        }
    manifest = {
        "format_version": INDEX_FORMAT_VERSION,
        "kind": "simhash_index",
        "n_bytes": int(index.n_bytes),
        "n_bits": int(index.n_bits),
        "n_codes": int(index.n_codes),
        "generation": gen,
        "chunks": entries,
        "tombstones": tomb,
        "sharded": {"shards": int(index.n_shards)},
    }
    if index.id_offset:
        manifest["id_offset"] = int(index.id_offset)
    # index-class extras: the sharded LSH tier spills its band keys in
    # global id order, agnostic of the layout like the chunks
    extra_hook = getattr(index, "_durable_extra", None)
    if extra_hook is not None:
        manifest.update(extra_hook(dirpath, gen))
    check_coverage(manifest)  # the writer holds itself to the invariant
    _commit_manifest(dirpath, manifest)
    for fn in _scan_orphans(dirpath, manifest):
        os.unlink(os.path.join(dirpath, fn))
    telemetry.emit(
        EVENTS.INDEX_SNAPSHOT_SAVE, path=dirpath, generation=gen,
        chunks=len(entries), n_codes=int(index.n_codes),
        deleted=int(index.n_deleted), shards=int(index.n_shards),
    )
    return manifest


def load_sharded_index(dirpath: str, *, mesh=None, devices=None,
                       n_shards=None, data_axis: str = "data", index_cls=None,
                       index_kwargs: Optional[dict] = None):
    """Rebuild a ``serving.ShardedSimHashIndex`` from a snapshot directory
    onto any shard layout (``mesh``/``devices``/``n_shards``, resolved as
    ``serving.shard_devices`` resolves them).  Reads snapshots of
    ``save_sharded_index`` and plain ``save_index`` ones alike (both hold
    the corpus in global id order): every chunk is verified before any
    upload, the corpus re-shards balanced, the tombstones re-arm at the new
    shard boundaries and ``id_offset`` comes back from the manifest, so
    ``query_topk`` answers as the saved index did."""
    from randomprojection_tpu_torch.serving.sharded_index import (
        ShardedSimHashIndex,
    )

    manifest = read_manifest(dirpath)
    check_coverage(manifest)
    parts = list(_verified_chunks(dirpath, manifest))
    codes = (
        np.concatenate(parts, axis=0)
        if parts
        else np.empty((0, manifest["n_bytes"]), np.uint8)
    )
    if codes.shape[0] != manifest["n_codes"]:
        raise ValueError(
            f"restored {codes.shape[0]} codes but the manifest records "
            f"{manifest['n_codes']}"
        )
    id_offset = int(manifest.get("id_offset", 0))
    cls = ShardedSimHashIndex if index_cls is None else index_cls
    index = cls(
        codes, mesh=mesh, devices=devices, n_shards=n_shards,
        data_axis=data_axis, n_bits=manifest["n_bits"],
        id_offset=id_offset, **(index_kwargs or {}),
    )
    tomb = manifest.get("tombstones")
    if tomb:
        packed = _load_chunk_verified(dirpath, tomb)
        dead = np.unpackbits(
            packed, count=manifest["n_codes"], bitorder="little"
        ).astype(bool)
        if int(dead.sum()) != tomb["deleted"]:
            raise ValueError(
                f"tombstone bitmap in {dirpath} marks {int(dead.sum())} "
                f"codes deleted but the manifest records {tomb['deleted']}"
            )
        index.delete(np.flatnonzero(dead).astype(np.int64) + id_offset)
    telemetry.emit(
        EVENTS.INDEX_SNAPSHOT_LOAD, path=dirpath,
        generation=manifest["generation"], chunks=len(manifest["chunks"]),
        n_codes=int(index.n_codes), deleted=int(index.n_deleted),
        shards=int(index.n_shards),
    )
    return index


def verify_snapshot(dirpath: str) -> dict:
    """Operational status of a snapshot directory: manifest validity,
    per-chunk checksums, orphan spills, row-range coverage.  Reports
    instead of raising; ``ok`` is the overall verdict."""
    status: dict = {"path": dirpath, "ok": False}
    try:
        manifest = read_manifest(dirpath)
    except FileNotFoundError:
        status["error"] = f"no {MANIFEST_NAME} in {dirpath}"
        return status
    except (ValueError, OSError) as e:
        status["error"] = str(e)
        return status
    try:
        return _verify_manifest(dirpath, manifest, status)
    except (KeyError, TypeError, AttributeError) as e:
        status["error"] = f"malformed manifest body in {dirpath}: {e!r}"
        return status


def _verify_manifest(dirpath: str, manifest: dict, status: dict) -> dict:
    tier = manifest.get("tier")
    status.update({
        "format_version": manifest["format_version"],
        "generation": manifest["generation"],
        "n_codes": manifest["n_codes"],
        "n_bytes": manifest["n_bytes"],
        "n_bits": manifest["n_bits"],
        "chunks": len(manifest["chunks"]),
        "deleted": (manifest.get("tombstones") or {}).get("deleted", 0),
        "rows_done": (manifest.get("ingest") or {}).get("rows_done"),
        "sharded": (manifest.get("sharded") or {}).get("shards"),
        "id_offset": manifest.get("id_offset", 0),
        "lsh": (
            {
                "bands": manifest["lsh"].get("bands"),
                "band_bits": manifest["lsh"].get("band_bits"),
            }
            if manifest.get("lsh")
            else None
        ),
        "tier": (
            {
                "cold_tier": tier.get("cold_tier"),
                "hbm_budget_bytes": tier.get("hbm_budget_bytes"),
                "hot_chunks": sum(
                    1 for e in tier.get("chunks", []) if e.get("tier") == "hot"
                ),
                "cold_chunks": sum(
                    1 for e in tier.get("chunks", []) if e.get("tier") != "hot"
                ),
            }
            if tier
            else None
        ),
    })
    corrupt = []
    try:
        _check_tier_block(manifest)
    except ValueError as e:
        corrupt.append({"file": MANIFEST_NAME, "error": str(e)})
    entries = list(manifest["chunks"])
    for extra in ("tombstones", "lsh"):
        if manifest.get(extra):
            entries.append(manifest[extra])
    for entry in entries:
        try:
            _load_chunk_verified(dirpath, entry)
        except ValueError as e:
            corrupt.append({"file": entry["file"], "error": str(e)})
    try:
        check_coverage(manifest)
        coverage_ok = True
    except ValueError as e:
        coverage_ok = False
        corrupt.append({"file": MANIFEST_NAME, "error": str(e)})
    status["corrupt"] = corrupt
    status["coverage_ok"] = coverage_ok
    status["orphan_chunks"] = _scan_orphans(dirpath, manifest)
    status["ok"] = not corrupt
    return status


@contextlib.contextmanager
def _one_cpu_thread(estimator):
    """One torch intra-op thread while ``estimator``'s torch backend
    encodes on the CPU, so its codes do not depend on the load."""
    import torch

    device = getattr(getattr(estimator, "_backend", None), "device", None)
    if device is None or torch.device(device).type != "cpu":
        yield
        return
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


class DurableIngest:
    """Crash-durable ingest of a packed-code stream into a ``SimHashIndex``
    on ``device`` (None: the card): the cursor commit and the chunk flush
    are one atomic manifest update, so a ``kill -9`` anywhere leaves a
    state that resumes exactly once.

    ``run(estimator, source)`` streams the source through the estimator
    (one that streams uint8 packed codes: ``SignRandomProjection``),
    appends each batch to the resident index and to a chunk spill, and
    commits ``rows_done`` with the new chunk entries in one manifest
    replace.  Crash windows: **mid-batch** (nothing durable written: the
    batch replays), **post-yield pre-ack** (the chunk file is an orphan,
    swept at resume with ``recover.orphan_chunk``, and the batch replays
    to an identical file) and **mid-snapshot-rename** (the manifest
    ``.tmp`` is swept; the committed manifest is the previous state).

    ``commit_every_batches`` amortises the fsyncs (a crash then replays up
    to that many batches); ``compact_after_chunks`` folds the per-batch
    chunks into one (a new generation) whenever the chunk count reaches
    it.  Compaction keeps ids, so codes and query results stay
    bit-identical to an uninterrupted run even where a crash moved the
    chunk layout.

    A replayed batch must encode to the bits it had before the crash.
    torch's threaded CPU GEMM may split a row's sums by the threads it
    finds free, so under load a code bit near zero could flip: while the
    estimator's torch backend runs on the CPU, ``run`` holds torch to one
    intra-op thread (and restores the count after).
    """

    def __init__(self, path: str, *, commit_every_batches: int = 1,
                 compact_after_chunks: Optional[int] = None, device=None):
        if commit_every_batches < 1:
            raise ValueError(
                f"commit_every_batches must be >= 1, got "
                f"{commit_every_batches}"
            )
        if compact_after_chunks is not None and compact_after_chunks < 2:
            raise ValueError(
                f"compact_after_chunks must be >= 2 or None, got "
                f"{compact_after_chunks}"
            )
        self.path = path
        self.commit_every_batches = int(commit_every_batches)
        self.compact_after_chunks = compact_after_chunks
        self.device = device

    # -- state ---------------------------------------------------------------

    def rows_done(self) -> int:
        """The committed cursor (0 when the directory has no manifest)."""
        try:
            manifest = read_manifest(self.path)
        except FileNotFoundError:
            return 0
        ingest = manifest.get("ingest")
        if ingest is None:
            raise ValueError(
                f"{self.path} holds a plain index snapshot, not a durable "
                "ingest (no cursor binding in its manifest)"
            )
        return int(ingest["rows_done"])

    def _resume_or_fresh(self, n_bytes: int, n_bits: int):
        """Load the committed state (verifying checksums), sweep crash
        debris, and report the resume point."""
        try:
            manifest = read_manifest(self.path)
        except FileNotFoundError:
            from randomprojection_tpu_torch.models.sketch import SimHashIndex

            os.makedirs(self.path, exist_ok=True)
            index = SimHashIndex(
                np.empty((0, n_bytes), np.uint8), n_bits=n_bits,
                device=self.device,
            )
            return index, 0, [], 0
        ingest = manifest.get("ingest")
        if ingest is None:
            raise ValueError(
                f"{self.path} holds a plain index snapshot, not a durable "
                "ingest run; point DurableIngest at its own directory"
            )
        if manifest["n_bytes"] != n_bytes or manifest["n_bits"] != n_bits:
            raise ValueError(
                f"durable ingest at {self.path} holds "
                f"{manifest['n_bits']}-bit/{manifest['n_bytes']}-byte "
                f"codes but the estimator streams {n_bits}-bit/"
                f"{n_bytes}-byte codes; resuming would mix two projections"
            )
        recorded = ingest.get("estimator")
        if recorded is not None and recorded != self._est_fp:
            raise ValueError(
                f"durable ingest at {self.path} was written by estimator "
                f"{recorded} but this run uses {self._est_fp}; resuming "
                "would mix two projections in one index"
            )
        for fn in _scan_orphans(self.path, manifest):
            telemetry.emit(EVENTS.RECOVER_ORPHAN_CHUNK, path=self.path,
                           file=fn)
            os.unlink(os.path.join(self.path, fn))
        check_coverage(manifest)
        index = load_index(self.path, device=self.device)
        return (
            index, int(ingest["rows_done"]), list(manifest["chunks"]),
            int(manifest["generation"]),
        )

    # -- the run -------------------------------------------------------------

    def run(self, estimator, source):
        """Ingest ``source`` through ``estimator`` into the durable index,
        resuming from the committed cursor; returns the live
        ``SimHashIndex`` (committed through the last batch)."""
        estimator._check_is_fitted()
        out_dtype = estimator._stream_out_dtype()
        if out_dtype is None or np.dtype(out_dtype) != np.uint8:
            raise ValueError(
                "DurableIngest ingests packed uint8 codes (e.g. "
                "SignRandomProjection); this estimator streams "
                f"{out_dtype!r}"
            )
        n_bytes = int(estimator._stream_out_width())
        n_bits = int(estimator.n_components_)
        self._est_fp = _estimator_fingerprint(estimator)
        index, rows_done, entries, gen = self._resume_or_fresh(
            n_bytes, n_bits
        )
        if rows_done > source.n_rows:
            raise ValueError(
                f"committed cursor rows_done={rows_done} exceeds the "
                f"source's {source.n_rows} rows; wrong source for this "
                "ingest directory"
            )
        if rows_done:
            telemetry.emit(
                EVENTS.RECOVER_RESUME, path=self.path,
                rows_done=rows_done,
                replay_rows=int(source.n_rows - rows_done),
            )
        self._entries = entries
        self._generation = gen
        pending: list = []
        with _one_cpu_thread(estimator):
            for lo, y in stream_transform(
                estimator, source, cursor=StreamCursor(rows_done)
            ):
                _maybe_kill("mid-batch")
                codes = np.ascontiguousarray(y, dtype=np.uint8)
                index.add(codes)
                pending.append((lo, codes))
                if len(pending) >= self.commit_every_batches:
                    self._commit(index, pending)
                    pending = []
                    if (
                        self.compact_after_chunks is not None
                        and len(self._entries) >= self.compact_after_chunks
                    ):
                        self._compact_commit(index)
        if pending:
            self._commit(index, pending)
        return index

    def _commit(self, index, pending: list) -> None:
        """One durable commit: flush the pending batches' chunk files,
        then bind the advanced cursor to them in one manifest replace."""
        rows_done = None
        for lo, codes in pending:
            self._entries.append(_spill_chunk(
                self.path, self._generation, len(self._entries), codes, lo
            ))
            rows_done = int(lo + codes.shape[0])
        _maybe_kill("post-yield-pre-ack")
        self._write_manifest(index, rows_done)
        telemetry.emit(
            EVENTS.INDEX_SNAPSHOT_SAVE, path=self.path,
            generation=self._generation, chunks=len(self._entries),
            n_codes=int(index.n_codes), deleted=int(index.n_deleted),
            rows_done=rows_done,
        )

    def _write_manifest(self, index, rows_done: int) -> None:
        _commit_manifest(self.path, {
            "format_version": INDEX_FORMAT_VERSION,
            "kind": "simhash_index",
            "n_bytes": int(index.n_bytes),
            "n_bits": int(index.n_bits),
            "n_codes": int(index.n_codes),
            "generation": self._generation,
            "chunks": self._entries,
            "tombstones": None,
            "ingest": {
                "rows_done": int(rows_done),
                "estimator": self._est_fp,
            },
        })

    def _compact_commit(self, index) -> None:
        """Fold the per-batch chunks into one (a new generation), read back
        from the committed spill files, and sweep the superseded files
        only after the new manifest is committed."""
        rows_done = self.rows_done()
        codes = _codes_of(self.path)
        # ingest never tombstones: the committed codes in id order ARE the
        # compacted content
        index._rebuild_from_host(codes)
        self._generation += 1
        old_files = [e["file"] for e in self._entries]
        self._entries = []
        if codes.shape[0]:
            self._entries.append(_spill_chunk(
                self.path, self._generation, 0, codes, 0
            ))
        self._write_manifest(index, rows_done)
        for fn in old_files:
            try:
                os.unlink(os.path.join(self.path, fn))
            except FileNotFoundError:  # pragma: no cover — already swept
                pass


# -- deterministic demo ingest + subprocess crash harness --------------------


def _demo_source(rows: int, batch_rows: int, d: int, seed: int, device):
    """Rows drawn on ``device`` by torch, each batch from a generator
    seeded by ``(seed, lo)``: a pure function of the batch's row range."""
    import torch

    from randomprojection_tpu_torch.streaming import CallableSource

    def read(lo, hi):
        state = np.random.SeedSequence([seed, lo]).generate_state(1, np.uint64)
        g = torch.Generator(device=device)
        g.manual_seed(int(state[0]))
        return torch.randn((hi - lo, d), generator=g, device=device)

    return CallableSource(read, rows, d, dtype=np.float32,
                          batch_rows=batch_rows)


def demo_ingest(path: str, *, rows: int = 192, batch_rows: int = 32,
                d: int = 16, bits: int = 64, seed: int = 0,
                commit_every: int = 1, compact_after: Optional[int] = None,
                device=None) -> dict:
    """The harness child: a deterministic SimHash ingest (rows drawn on
    ``device`` (None: the card) → ``SignRandomProjection`` on the torch
    backend there → ``DurableIngest``) whose every byte is a pure function
    of the arguments, so a killed-and-resumed run can be compared bit for
    bit with a clean one.  Returns a summary dict.

    After the ingest, a tiered-demotion leg re-opens the committed codes as
    a disk-tiered index (spills in ``<path>/cold``, a subdirectory the
    orphan sweep never enters) and demotes every chunk: each demotion
    crosses the ``mid-demotion`` kill point between its spill write and
    its residency swap."""
    from randomprojection_tpu_torch.models.sketch import (
        SignRandomProjection,
        SimHashIndex,
    )

    device = _harness_device(device)
    source = _demo_source(rows, batch_rows, d, seed, device)
    est = SignRandomProjection(bits, random_state=seed, backend="torch",
                               backend_options={"device": device})
    est.fit_source(source)
    ingest = DurableIngest(path, commit_every_batches=commit_every,
                           compact_after_chunks=compact_after, device=device)
    index = ingest.run(est, source)
    tiered = SimHashIndex(
        np.empty((0, index.n_bytes), np.uint8), n_bits=index.n_bits,
        device=device, hbm_budget_bytes=1 << 40, cold_tier="disk",
        cold_dir=os.path.join(path, "cold"),
    )
    try:
        for chunk in index._chunks:
            tiered.add(index._fetch_chunk_host(chunk))
        demoted = sum(tiered._tier.demote(c.row0) for c in tiered._chunks)
    finally:
        tiered.close()
    return {
        "path": path,
        "rows_done": ingest.rows_done(),
        "n_codes": int(index.n_codes),
        "chunks": len(index._chunks),
        "tier_demotions": int(demoted),
    }


def _harness_device(device) -> str:
    """``device`` resolved as every entry point of the port resolves it
    (None: the card), as the string a child's ``--device`` takes."""
    from randomprojection_tpu_torch.backends.torch_backend import resolve_device

    return str(resolve_device(device, how="device='cpu'"))


def _package_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _child_argv(path: str, *, rows: int, batch_rows: int, d: int, bits: int,
                seed: int, commit_every: int, compact_after: Optional[int],
                device: str) -> list:
    argv = [
        sys.executable, "-m", "randomprojection_tpu_torch.durable",
        "--child", path, "--rows", str(rows),
        "--batch-rows", str(batch_rows), "--d", str(d),
        "--bits", str(bits), "--seed", str(seed),
        "--commit-every", str(commit_every), "--device", device,
    ]
    if compact_after is not None:
        argv += ["--compact-after", str(compact_after)]
    return argv


def _build_kernels() -> None:
    """Build every CUDA library of the port before a child on the card
    starts, so no child is killed inside an ``nvcc`` build."""
    from randomprojection_tpu_torch.ops import _build

    for src in sorted(_build.CSRC.glob("*.cu")):
        _build.build(src.stem)


def run_child(path: str, *, rows: int = 192, batch_rows: int = 32,
              d: int = 16, bits: int = 64, seed: int = 0,
              commit_every: int = 1, compact_after: Optional[int] = None,
              device=None, kill: Optional[str] = None,
              timeout: float = 180.0):
    """Run one harness child ingest on ``device`` (None: the card) as a
    real subprocess (so SIGKILL kills a whole process).  ``kill`` is a
    ``"<point>@<n>"`` spec for ``RP_DURABLE_KILL``; returns the
    ``CompletedProcess`` (returncode ``-SIGKILL`` when the kill fired)."""
    device = _harness_device(device)
    if device != "cpu":
        _build_kernels()
    env = os.environ.copy()
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_package_root(), env.get("PYTHONPATH")) if p
    )
    env.pop(KILL_ENV, None)
    if kill is not None:
        env[KILL_ENV] = kill
    return subprocess.run(
        _child_argv(path, rows=rows, batch_rows=batch_rows, d=d, bits=bits,
                    seed=seed, commit_every=commit_every,
                    compact_after=compact_after, device=device),
        capture_output=True, text=True, timeout=timeout, env=env,
    )


def _codes_of(dirpath: str) -> np.ndarray:
    """All committed codes of a snapshot, in global id order, straight
    from the verified spill files (no device round trip)."""
    manifest = read_manifest(dirpath)
    check_coverage(manifest)
    parts = [_load_chunk_verified(dirpath, e) for e in manifest["chunks"]]
    return (
        np.concatenate(parts, axis=0)
        if parts
        else np.empty((0, manifest["n_bytes"]), np.uint8)
    )


def crash_smoke(workdir: str, *, rows: int = 192, batch_rows: int = 32,
                d: int = 16, bits: int = 64, seed: int = 0,
                commit_every: int = 1, compact_after: Optional[int] = None,
                device=None, query_m: int = 5,
                points=KILL_POINTS, nth: int = 3,
                timeout: float = 180.0) -> dict:
    """The process-kill fault matrix on ``device`` (None: the card): one
    clean child run, then for each of ``points`` a child SIGKILLed at that
    point's ``nth`` hit and a child that resumes it.  Holds every
    recovered directory to the clean one: the kill fired, row ranges tile
    exactly once, codes and the manifests' chunk checksums are identical,
    and ``query_topk`` answers match.  Returns a verdict dict (``ok`` plus
    per-case detail) and raises nothing."""
    import shutil

    device = _harness_device(device)
    shapes = dict(rows=rows, batch_rows=batch_rows, d=d, bits=bits,
                  seed=seed, commit_every=commit_every,
                  compact_after=compact_after, device=device)

    def fresh(name: str) -> str:
        # a leftover completed ingest would resume with nothing to replay
        path = os.path.join(workdir, name)
        shutil.rmtree(path, ignore_errors=True)
        return path

    def child(path, **kw):
        try:
            return run_child(path, timeout=timeout, **shapes, **kw)
        except subprocess.TimeoutExpired as e:
            return subprocess.CompletedProcess(
                e.cmd, returncode=999,
                stdout="", stderr=f"harness child timed out: {e}",
            )

    clean_dir = fresh("clean")
    proc = child(clean_dir)
    if proc.returncode != 0:
        return {
            "ok": False, "error": "clean ingest failed",
            "returncode": proc.returncode, "stderr": proc.stderr[-2000:],
        }
    clean_manifest = read_manifest(clean_dir)
    clean_codes = _codes_of(clean_dir)
    rng = np.random.default_rng(seed + 1)
    queries = rng.integers(
        0, 256, size=(8, clean_manifest["n_bytes"]), dtype=np.uint8
    )
    ref_d, ref_i = load_index(clean_dir, device=device).query_topk(
        queries, query_m
    )
    cases = []
    ok = True
    for point in points:
        case: dict = {"kill_at": f"{point}@{nth}"}
        cases.append(case)
        case_dir = fresh(point.replace("-", "_"))
        crashed = child(case_dir, kill=f"{point}@{nth}")
        case["crash_returncode"] = crashed.returncode
        if crashed.returncode != -signal.SIGKILL:
            case["error"] = (
                "kill point never fired (run finished with "
                f"rc={crashed.returncode}): the harness is not covering "
                f"this window; {crashed.stderr[-2000:]}"
            )
            ok = False
            continue
        resumed = child(case_dir)
        case["resume_returncode"] = resumed.returncode
        if resumed.returncode != 0:
            case["error"] = f"resume failed: {resumed.stderr[-2000:]}"
            ok = False
            continue
        try:
            manifest = read_manifest(case_dir)
            check_coverage(manifest)
            codes = _codes_of(case_dir)
        except ValueError as e:
            case["error"] = f"recovered state invalid: {e}"
            ok = False
            continue
        case["rows_done"] = manifest["ingest"]["rows_done"]
        case["bit_identical_codes"] = bool(np.array_equal(codes, clean_codes))
        case["manifest_chunks_identical"] = [
            e["sha256"] for e in manifest["chunks"]
        ] == [e["sha256"] for e in clean_manifest["chunks"]]
        got_d, got_i = load_index(case_dir, device=device).query_topk(
            queries, query_m
        )
        case["query_results_match"] = bool(
            np.array_equal(got_d, ref_d) and np.array_equal(got_i, ref_i)
        )
        if not (
            case["bit_identical_codes"]
            and case["manifest_chunks_identical"]
            and case["query_results_match"]
            and case["rows_done"] == rows
        ):
            ok = False
    return {"ok": ok, "workdir": workdir, "shapes": shapes, "cases": cases}


def _main(argv=None) -> int:
    """``python -m randomprojection_tpu_torch.durable --child <dir> ...``:
    one harness child ingest; prints its summary as one JSON line."""
    p = argparse.ArgumentParser(prog="python -m randomprojection_tpu_torch.durable")
    p.add_argument("--child", required=True, metavar="DIR")
    p.add_argument("--rows", type=int, default=192)
    p.add_argument("--batch-rows", type=int, default=32)
    p.add_argument("--d", type=int, default=16)
    p.add_argument("--bits", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--commit-every", type=int, default=1)
    p.add_argument("--compact-after", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="a torch device ('cpu', 'cuda', 'cuda:1'); "
                        "default: the card")
    a = p.parse_args(argv)
    from randomprojection_tpu_torch.backends.torch_backend import resolve_device

    device = str(resolve_device(a.device, how="--device cpu"))
    # the package's own module, so the kill counters are the ones the
    # ingest reaches (not a second copy under __main__)
    from randomprojection_tpu_torch import durable

    summary = durable.demo_ingest(
        a.child, rows=a.rows, batch_rows=a.batch_rows, d=a.d, bits=a.bits,
        seed=a.seed, commit_every=a.commit_every,
        compact_after=a.compact_after, device=device,
    )
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(_main())
