"""The port's ``StagedIngestSource`` against the JAX package's streaming.

The pool's output equals the serial stream and the prefetched one bit for
bit at any worker count, on the torch backend (on the CPU) and the numpy
backend, and the numpy backend's staged stream equals the reference's
serial stream; a fault through the pool commits the serial prefix and the
cursor resume covers every row once; a prepare failure keeps its
traceback; a break joins every ``rp-torch-staged-*`` thread; host memory
stays within ``2·workers + depth + 2`` produced batches; the config-5
token pipeline through the pool equals the prefetched one.  The serving
tiles' ``tile_pipeline`` finishes each tile a fixed number of tiles after
its dispatch, in order, and drops the tiles in flight when a half raises.
"""

import threading
import time

import numpy as np
import pytest
import scipy.sparse as sp

import randomprojection_tpu as ref
from randomprojection_tpu import streaming as ref_stream
from randomprojection_tpu_torch import CountSketch, GaussianRandomProjection
from randomprojection_tpu_torch.ops.hashing import FeatureHasher
from randomprojection_tpu_torch.ops.staging import tile_pipeline
from randomprojection_tpu_torch.streaming import (
    ArraySource,
    CallableSource,
    FaultInjectionSource,
    PrefetchSource,
    StagedIngestSource,
    StreamCursor,
    TokenSource,
    stream_to_memmap,
    stream_transform,
)
from randomprojection_tpu_torch.utils.observability import StreamStats

CPU = {"device": "cpu"}


def staged_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("rp-torch-staged")]


@pytest.fixture
def X():
    return np.random.default_rng(0).normal(size=(1000, 128)).astype(np.float32)


def make_est(backend="numpy", k=16):
    opts = CPU if backend == "torch" else None
    return GaussianRandomProjection(k, random_state=0, backend=backend,
                                    backend_options=opts)


def _stack(items):
    return np.concatenate([np.asarray(y) for _, y in items])


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("workers", [1, 2, 4])
def test_staged_equals_prefetch_equals_serial(X, backend, workers):
    est = make_est(backend).fit(X)
    serial = list(est.transform_stream(ArraySource(X, 128)))
    prefetch = list(est.transform_stream(PrefetchSource(
        ArraySource(X, 128), depth=2, prepare=est.prepare_batch)))
    staged = list(est.transform_stream(StagedIngestSource(
        ArraySource(X, 128), workers=workers, depth=2,
        prepare=est.prepare_batch)))
    want = [lo for lo, _ in serial]
    assert [lo for lo, _ in staged] == want == [lo for lo, _ in prefetch]
    np.testing.assert_array_equal(_stack(staged), _stack(serial))
    np.testing.assert_array_equal(_stack(prefetch), _stack(serial))
    assert not staged_threads()


def test_staged_numpy_stream_equals_the_reference(X):
    port = GaussianRandomProjection(16, random_state=4, backend="numpy").fit(X)
    want = ref.GaussianRandomProjection(16, random_state=4,
                                        backend="numpy").fit(X)
    got = _stack(stream_transform(port, StagedIngestSource(
        ArraySource(X, 96), workers=3, prepare=port.prepare_batch)))
    expect = _stack(ref_stream.stream_transform(
        want, ref_stream.ArraySource(X, 96)))
    np.testing.assert_array_equal(got, expect)


def test_staged_validation(X):
    with pytest.raises(ValueError, match="workers"):
        StagedIngestSource(ArraySource(X, 128), workers=0)
    with pytest.raises(ValueError, match="depth"):
        StagedIngestSource(ArraySource(X, 128), depth=0)
    with pytest.raises(ValueError, match="start_row"):
        list(StagedIngestSource(ArraySource(X, 128)).iter_batches(3))


def test_staged_schema_delegates(X):
    src = StagedIngestSource(ArraySource(X, 128), workers=2)
    assert src.schema() == ArraySource(X, 128).schema()
    assert src.batch_rows == 128


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("workers", [2, 3])
def test_staged_fault_resume_never_drops_or_double_commits(X, tmp_path,
                                                           backend, workers):
    est = make_est(backend).fit(X)
    Y_ref = _stack(est.transform_stream(ArraySource(X, 128)))
    ckpt_ref = str(tmp_path / "ref.json")
    ref_rows = []
    with pytest.raises(FaultInjectionSource.InjectedFault):
        for lo, _ in est.transform_stream(
                FaultInjectionSource(ArraySource(X, 128), 3),
                checkpoint_path=ckpt_ref):
            ref_rows.append(lo)
    serial_committed = StreamCursor.load(ckpt_ref).rows_done

    ckpt = str(tmp_path / "cursor.json")
    inner = FaultInjectionSource(ArraySource(X, 128), fail_after_batches=3)
    src = StagedIngestSource(inner, workers=workers, depth=2,
                             prepare=est.prepare_batch)
    got = []
    with pytest.raises(FaultInjectionSource.InjectedFault):
        for lo, y in est.transform_stream(src, checkpoint_path=ckpt):
            got.append((lo, y))
    assert not staged_threads()
    committed = StreamCursor.load(ckpt).rows_done
    assert committed == serial_committed == sum(y.shape[0] for _, y in got)
    assert [lo for lo, _ in got] == ref_rows
    inner.disarm()
    for lo, y in est.transform_stream(src, checkpoint_path=ckpt):
        assert lo == committed
        committed += y.shape[0]
        got.append((lo, y))
    assert [lo for lo, _ in got] == list(range(0, 1000, 128))
    np.testing.assert_array_equal(_stack(got), Y_ref)
    assert not staged_threads()


def test_staged_prepare_exception_keeps_its_traceback(X):
    class PrepareBoom(RuntimeError):
        pass

    def bad_prepare(batch):
        raise PrepareBoom("prepare failed")

    est = make_est().fit(X)
    with pytest.raises(PrepareBoom) as info:
        list(est.transform_stream(StagedIngestSource(
            ArraySource(X, 128), workers=2, depth=2, prepare=bad_prepare)))
    assert any(f.name == "bad_prepare" for f in info.traceback)
    assert not staged_threads()


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_staged_break_joins_every_worker(X, backend):
    est = make_est(backend).fit(X)
    for i, _ in enumerate(est.transform_stream(StagedIngestSource(
            ArraySource(X, 64), workers=3, depth=2,
            prepare=est.prepare_batch))):
        if i == 2:
            break
    assert not staged_threads()


@pytest.mark.parametrize("workers,depth", [(2, 1), (3, 2)])
def test_staged_host_memory_bounded(X, workers, depth):
    produced = []
    lock = threading.Lock()

    def read(lo, hi):
        with lock:
            produced.append(lo)
        return X[lo:hi]

    src = StagedIngestSource(CallableSource(read, 1000, 128, batch_rows=32),
                             workers=workers, depth=depth)
    ahead = []
    for i, (lo, _) in enumerate(src.iter_batches()):
        assert lo == 32 * i
        time.sleep(0.02)
        with lock:
            ahead.append(len(produced) - i)
    assert len(produced) == 32
    assert max(ahead) <= 2 * workers + depth + 2
    assert max(ahead) >= depth
    assert not staged_threads()


def test_staged_cursor_resume_is_bit_identical(X, tmp_path):
    est = make_est("torch").fit(X)
    Y_ref = _stack(est.transform_stream(ArraySource(X, 100)))
    ckpt = str(tmp_path / "c.json")
    parts = {}
    src = StagedIngestSource(ArraySource(X, 100), workers=3,
                             prepare=est.prepare_batch)
    for i, (lo, y) in enumerate(est.transform_stream(src,
                                                     checkpoint_path=ckpt)):
        parts[lo] = y
        if i == 4:
            break
    assert StreamCursor.load(ckpt).rows_done == 400  # batch 4 not acked
    for lo, y in est.transform_stream(src, checkpoint_path=ckpt):
        parts[lo] = y
    np.testing.assert_array_equal(
        np.concatenate([parts[lo] for lo in sorted(parts)]), Y_ref)


def test_staged_stream_to_memmap_fault_resume(X, tmp_path):
    est = make_est("torch").fit(X)
    clean = np.asarray(stream_to_memmap(
        est, ArraySource(X, 128), str(tmp_path / "a.npy"),
        checkpoint_path=str(tmp_path / "a.json")))
    inner = FaultInjectionSource(ArraySource(X, 128), fail_after_batches=4)
    src = StagedIngestSource(inner, workers=2, prepare=est.prepare_batch)
    out, ckpt = str(tmp_path / "b.npy"), str(tmp_path / "b.json")
    with pytest.raises(FaultInjectionSource.InjectedFault):
        stream_to_memmap(est, src, out, checkpoint_path=ckpt)
    inner.disarm()
    np.testing.assert_array_equal(
        np.asarray(stream_to_memmap(est, src, out, checkpoint_path=ckpt)),
        clean)
    assert not staged_threads()


def test_staged_empty_and_tail(X):
    est = make_est().fit(X)
    src = StagedIngestSource(ArraySource(X, 300), workers=2)
    assert list(src.iter_batches(1000)) == []
    got = list(est.transform_stream(src))
    assert [lo for lo, _ in got] == [0, 300, 600, 900]
    assert got[-1][1].shape[0] == 100
    assert not staged_threads()


def _tokens(seed0=900):
    words = np.asarray([f"w{i}" for i in range(2000)])

    def read_tokens(lo, hi):
        rngs = [np.random.default_rng(seed0 + i) for i in range(lo, hi)]
        toks = np.concatenate(
            [words[r.integers(0, len(words), size=10)] for r in rngs])
        return toks, np.arange(0, (hi - lo) * 10 + 10, 10)

    return read_tokens


def test_staged_token_pipeline_matches_prefetch():
    fh = FeatureHasher(1 << 14, input_type="string", dtype=np.float32)
    cs = CountSketch(16, random_state=0, backend_options=CPU).fit_schema(
        128, 1 << 14, np.float32)
    stats = StreamStats()
    want = _stack(stream_transform(cs, PrefetchSource(
        TokenSource(_tokens(), 128, fh, batch_rows=32), depth=2,
        prepare=cs.prepare_batch)))
    got = _stack(stream_transform(cs, StagedIngestSource(
        TokenSource(_tokens(), 128, fh, batch_rows=32, hash_threads=1,
                    stats=stats),
        workers=3, depth=2, prepare=cs.prepare_batch, stats=stats),
        stats=stats))
    np.testing.assert_array_equal(got, want)
    assert {"hash", "h2d", "dispatch", "d2h"} <= set(stats.stage_wall)
    assert stats.registry.gauge("stream.queue_depth")["n"] == 4
    X = sp.vstack([b for _, b in TokenSource(_tokens(), 128, fh, 32)
                   .iter_batches()]).tocsr()
    np.testing.assert_allclose(
        got, ref.CountSketch(16, random_state=0, backend="numpy").fit(X)
        .transform(X.astype(np.float64)), rtol=2e-5, atol=2e-5)
    assert not staged_threads()


# -- the serving tiles' pipeline ---------------------------------------------------


def _pipeline_log(n, tile, behind, *, fail_at=None, fail_in="finish"):
    """Run ``tile_pipeline`` with recording halves; the half named
    ``fail_in`` raises at the tile starting at row ``fail_at``."""
    log = []

    def dispatch(lo, hi):
        log.append(("dispatch", lo, hi))
        if fail_in == "dispatch" and lo == fail_at:
            raise RuntimeError("dispatch failed")
        return ("payload", lo, hi)

    def finish(lo, hi, payload):
        assert payload == ("payload", lo, hi)
        log.append(("finish", lo, hi))
        if fail_in == "finish" and lo == fail_at:
            raise RuntimeError("finish failed")

    try:
        tile_pipeline(n, tile, dispatch, finish, behind=behind)
    except RuntimeError as e:
        return log, e
    return log, None


@pytest.mark.parametrize("behind", [1, 8])
@pytest.mark.parametrize("tiles", ["fewer", "equal", "more"])
def test_tile_pipeline_finishes_each_tile_behind_tiles_later(behind, tiles):
    n_tiles = {"fewer": behind // 2, "equal": behind, "more": 2 * behind + 3}[tiles]
    tile = 5
    n = max(n_tiles * tile - 2, 0)  # a ragged last tile
    log, err = _pipeline_log(n, tile, behind)
    assert err is None
    bounds = [(k * tile, min(k * tile + tile, n)) for k in range(n_tiles)]
    want = []
    for k, (lo, hi) in enumerate(bounds):
        want.append(("dispatch", lo, hi))
        if k >= behind:  # finished right after the dispatch `behind` later
            want.append(("finish",) + bounds[k - behind])
    want += [("finish",) + b for b in bounds[max(n_tiles - behind, 0):]]
    assert log == want


@pytest.mark.parametrize("behind", [1, 8])
@pytest.mark.parametrize("fail_in", ["dispatch", "finish"])
def test_tile_pipeline_raises_and_drops_the_tiles_in_flight(behind, fail_in):
    tile, fail_at = 4, 2
    log, err = _pipeline_log(tile * (behind + 4), tile, behind,
                             fail_at=fail_at * tile, fail_in=fail_in)
    assert err is not None and str(err) == f"{fail_in} failed"
    dispatched = [lo // tile for what, lo, _ in log if what == "dispatch"]
    finished = [lo // tile for what, lo, _ in log if what == "finish"]
    if fail_in == "finish":
        # the failing finish came after tile fail_at + behind's dispatch;
        # nothing was dispatched or finished after it
        assert dispatched == list(range(fail_at + behind + 1))
        assert finished == list(range(fail_at + 1))
        assert log[-1] == ("finish", fail_at * tile, fail_at * tile + tile)
    else:
        assert dispatched == list(range(fail_at + 1))
        assert finished == list(range(max(fail_at - behind, 0)))
