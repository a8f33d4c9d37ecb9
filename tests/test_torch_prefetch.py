"""The port's ``PrefetchSource`` against the JAX package's streaming.

The same seeded numpy rows go through the reference's ``stream_transform``
and the port's: order and values of a prefetched stream equal the serial
one bit for bit on the torch backend (on the CPU) and the numpy backend;
the numpy backend's stream equals the reference's bit for bit; a worker's
failure reaches the consumer after the batches before it; a break joins
the worker (threads named ``rp-torch-prefetch-*``); host memory stays
bounded by the depth; a cursor resume and ``stream_to_memmap`` killed by a
``FaultInjectionSource`` and resumed are bit-identical; and the stage
walls, queue gauge and ``StreamStats.summary()`` are recorded.
"""

import threading
import time

import numpy as np
import pytest
import scipy.sparse as sp

import randomprojection_tpu as ref
from randomprojection_tpu import streaming as ref_stream
from randomprojection_tpu_torch import (
    CountSketch,
    GaussianRandomProjection,
    SparseRandomProjection,
)
from randomprojection_tpu_torch.models.sketch import DeviceBatch
from randomprojection_tpu_torch.ops.hashing import FeatureHasher
from randomprojection_tpu_torch.streaming import (
    ArraySource,
    CallableSource,
    FaultInjectionSource,
    PrefetchSource,
    StreamCursor,
    TokenSource,
    stream_to_memmap,
    stream_transform,
)
from randomprojection_tpu_torch.utils.observability import StreamStats

CPU = {"device": "cpu"}


def prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("rp-torch-prefetch")]


@pytest.fixture
def X():
    return np.random.default_rng(0).normal(size=(1000, 128)).astype(np.float32)


def make_est(backend="numpy", k=16):
    opts = CPU if backend == "torch" else None
    return GaussianRandomProjection(k, random_state=0, backend=backend,
                                    backend_options=opts)


def _stack(items):
    return np.concatenate([y for _, y in items])


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_prefetch_matches_serial(X, backend, depth):
    est = make_est(backend).fit(X)
    ref_items = list(est.transform_stream(ArraySource(X, 128)))
    got = list(est.transform_stream(
        PrefetchSource(ArraySource(X, 128), depth=depth,
                       prepare=est.prepare_batch)))
    assert [lo for lo, _ in got] == [lo for lo, _ in ref_items]
    np.testing.assert_array_equal(_stack(got), _stack(ref_items))
    assert not prefetch_threads()


@pytest.mark.parametrize("depth", [0, 2])
def test_numpy_stream_equals_the_reference_stream(X, depth):
    """The port's numpy backend streams the reference's bits, prefetched
    or not."""
    port = SparseRandomProjection(16, density=1 / 3, random_state=3,
                                  backend="numpy").fit(X)
    want = ref.SparseRandomProjection(16, density=1 / 3, random_state=3,
                                      backend="numpy").fit(X)
    src = ArraySource(X, 100)
    if depth:
        src = PrefetchSource(src, depth=depth, prepare=port.prepare_batch)
    got = list(stream_transform(port, src))
    expect = list(ref_stream.stream_transform(want, ref_stream.ArraySource(X, 100)))
    assert [lo for lo, _ in got] == [lo for lo, _ in expect]
    np.testing.assert_array_equal(_stack(got), _stack(expect))


def test_prefetch_depth_validation(X):
    with pytest.raises(ValueError, match="depth"):
        PrefetchSource(ArraySource(X, 128), depth=0)


def test_prefetch_schema_delegates(X):
    src = PrefetchSource(ArraySource(X, 128), depth=2)
    assert src.schema() == ArraySource(X, 128).schema()
    assert src.batch_rows == 128


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_prefetch_fault_resume_bit_identical(X, tmp_path, backend):
    """A fault in the worker reaches the consumer after its prefix, with
    no thread left; the cursor resume is bit-identical."""
    ckpt = str(tmp_path / "cursor.json")
    est = make_est(backend).fit(X)
    Y_ref = _stack(est.transform_stream(ArraySource(X, 128)))
    serial = []  # the serial source's prefix at the same fault
    with pytest.raises(FaultInjectionSource.InjectedFault):
        for lo, _ in est.transform_stream(
                FaultInjectionSource(ArraySource(X, 128), 3)):
            serial.append(lo)
    inner = FaultInjectionSource(ArraySource(X, 128), fail_after_batches=3)
    src = PrefetchSource(inner, depth=2, prepare=est.prepare_batch)
    got = []
    with pytest.raises(FaultInjectionSource.InjectedFault):
        for lo, y in est.transform_stream(src, checkpoint_path=ckpt):
            got.append((lo, y))
    assert not prefetch_threads()
    committed = StreamCursor.load(ckpt).rows_done
    assert [lo for lo, _ in got] == serial and serial
    assert committed == sum(y.shape[0] for _, y in got)
    inner.disarm()
    for lo, y in est.transform_stream(src, checkpoint_path=ckpt):
        assert lo == committed
        committed += y.shape[0]
        got.append((lo, y))
    np.testing.assert_array_equal(_stack(got), Y_ref)
    assert not prefetch_threads()


def test_prefetch_prepare_exception_keeps_its_traceback(X):
    class PrepareBoom(RuntimeError):
        pass

    def bad_prepare(batch):
        raise PrepareBoom("prepare failed")

    est = make_est().fit(X)
    with pytest.raises(PrepareBoom) as info:
        list(est.transform_stream(
            PrefetchSource(ArraySource(X, 128), depth=2,
                           prepare=bad_prepare)))
    # the worker's frames travel with the exception
    assert any(f.name == "bad_prepare" for f in info.traceback)
    assert not prefetch_threads()


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_prefetch_consumer_break_joins_worker(X, backend):
    est = make_est(backend).fit(X)
    for i, _ in enumerate(est.transform_stream(
            PrefetchSource(ArraySource(X, 128), depth=2,
                           prepare=est.prepare_batch))):
        if i == 1:
            break
    assert not prefetch_threads()


def test_prefetch_consumer_crash_does_not_commit_inflight(X, tmp_path):
    ckpt = str(tmp_path / "cursor.json")
    est = make_est().fit(X)
    Y_ref = _stack(est.transform_stream(ArraySource(X, 128)))

    class ConsumerCrash(RuntimeError):
        pass

    written = {}
    with pytest.raises(ConsumerCrash):
        for lo, y in est.transform_stream(
                PrefetchSource(ArraySource(X, 128), depth=4),
                checkpoint_path=ckpt):
            if lo == 256:
                raise ConsumerCrash("crash before persisting this batch")
            written[lo] = y
    assert not prefetch_threads()
    assert StreamCursor.load(ckpt).rows_done == 256
    for lo, y in est.transform_stream(
            PrefetchSource(ArraySource(X, 128), depth=4),
            checkpoint_path=ckpt):
        written[lo] = y
    np.testing.assert_array_equal(
        np.concatenate([written[lo] for lo in sorted(written)]), Y_ref)


@pytest.mark.parametrize("depth", [1, 3])
def test_prefetch_host_memory_bounded_by_depth(X, depth):
    """A slow consumer never has more than depth + 2 batches produced and
    not yet consumed: the queue, the worker's hands and its own."""
    produced = []
    lock = threading.Lock()

    def read(lo, hi):
        with lock:
            produced.append(lo)
        return X[lo:hi]

    src = PrefetchSource(CallableSource(read, 1000, 128, batch_rows=64),
                         depth=depth)
    ahead = []
    for i, (lo, _) in enumerate(src.iter_batches()):
        time.sleep(0.02)
        with lock:
            ahead.append(len(produced) - i)
    assert len(produced) == 16
    assert max(ahead) <= depth + 2
    assert max(ahead) >= depth  # the worker did run ahead
    assert not prefetch_threads()


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_stream_to_memmap_fault_resume_equals_uninterrupted(X, tmp_path,
                                                            backend):
    est = make_est(backend).fit(X)
    clean = stream_to_memmap(est, ArraySource(X, 128),
                             str(tmp_path / "clean.npy"),
                             checkpoint_path=str(tmp_path / "clean.json"))
    out, ckpt = str(tmp_path / "cut.npy"), str(tmp_path / "cut.json")
    inner = FaultInjectionSource(ArraySource(X, 128), fail_after_batches=5)
    src = PrefetchSource(inner, depth=2, prepare=est.prepare_batch)
    with pytest.raises(FaultInjectionSource.InjectedFault):
        stream_to_memmap(est, src, out, checkpoint_path=ckpt)
    assert 0 < StreamCursor.load(ckpt).rows_done < 1000
    inner.disarm()
    got = stream_to_memmap(est, src, out, checkpoint_path=ckpt)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(clean))
    np.testing.assert_array_equal(np.load(out), est.transform(X))
    assert not prefetch_threads()


def test_stream_to_memmap_refuses_another_run(X, tmp_path):
    est = make_est().fit(X)
    out, ckpt = str(tmp_path / "y.npy"), str(tmp_path / "c.json")
    inner = FaultInjectionSource(ArraySource(X, 128), fail_after_batches=2)
    with pytest.raises(FaultInjectionSource.InjectedFault):
        stream_to_memmap(est, inner, out, checkpoint_path=ckpt)
    other = make_est(k=8).fit(X)
    with pytest.raises(ValueError, match="mix two projections"):
        stream_to_memmap(other, ArraySource(X, 128), out,
                         checkpoint_path=ckpt)
    with pytest.raises(ValueError, match=r"\.npy"):
        stream_to_memmap(est, ArraySource(X, 128), str(tmp_path / "y.bin"),
                         checkpoint_path=ckpt)


def test_torch_prepare_batch_on_the_cpu_is_the_transform_input(X):
    est = make_est("torch").fit(X)
    prepared = est.prepare_batch(X[:128])
    np.testing.assert_array_equal(
        est._transform_async(prepared).numpy(), est.transform(X[:128]))


def _tokens():
    words = np.asarray([f"w{i}" for i in range(2000)])

    def read_tokens(lo, hi):
        rngs = [np.random.default_rng(500 + i) for i in range(lo, hi)]
        toks = np.concatenate(
            [words[r.integers(0, len(words), size=10)] for r in rngs])
        return toks, np.arange(0, (hi - lo) * 10 + 1, 10)

    return read_tokens


def test_countsketch_prefetch_stream_matches_the_reference():
    """Config 5's composition on the torch backend (CPU): TokenSource →
    prefetch with ``prepare_batch`` (a ``DeviceBatch``) → the flat route,
    within 2e-5 of the reference's numpy sketch of the same batches."""
    fh = FeatureHasher(1 << 14, input_type="string", dtype=np.float32)
    cs = CountSketch(16, random_state=0, backend_options=CPU).fit_schema(
        128, 1 << 14, np.float32)
    assert isinstance(cs.prepare_batch(
        next(TokenSource(_tokens(), 128, fh, 32).iter_batches())[1]),
        DeviceBatch)
    got = _stack(stream_transform(cs, PrefetchSource(
        TokenSource(_tokens(), 128, fh, batch_rows=32), depth=2,
        prepare=cs.prepare_batch)))
    X = sp.vstack([b for _, b in TokenSource(_tokens(), 128, fh, 32)
                   .iter_batches()]).tocsr()
    want = ref.CountSketch(16, random_state=0, backend="numpy").fit(X) \
        .transform(X.astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_stream_stats_stage_attribution_and_queue_gauge():
    fh = FeatureHasher(1 << 14, input_type="string", dtype=np.float32)
    stats = StreamStats()
    source = PrefetchSource(
        TokenSource(_tokens(), 128, fh, batch_rows=32, hash_threads=2,
                    stats=stats),
        depth=2, stats=stats)
    cs = CountSketch(16, random_state=0, backend_options=CPU).fit_source(source)
    rows = sum(y.shape[0] for _, y in stream_transform(cs, source, stats=stats))
    assert rows == 128
    assert {"hash", "dispatch", "d2h"} <= set(stats.stage_wall)
    assert all(v >= 0 for v in stats.stage_wall.values())
    assert 0.0 <= stats.overlap_ratio() < 1.0
    assert stats.registry.gauge("stream.queue_depth")["n"] == 4
    assert 0 <= stats.queue_depth_max <= 2
    s = stats.summary()
    assert "stage_wall_s" in s and "pipeline_overlap_ratio" in s
    assert s["queue_depth_max"] == stats.queue_depth_max
    assert s["batches"] == 4 and s["rows"] == 128
