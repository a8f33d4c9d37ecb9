"""Card tests of the PyTorch port: each CUDA kernel against its plain
version on the same inputs, and the estimators' card routes.

They need an NVIDIA card and ``nvcc``; elsewhere every test skips with the
reason.  The decision is made inside the ``cuda`` fixture, never at
import, so every pytest-xdist worker collects the same tests.  On a
machine with a card, from the repository root (``--noconftest``: the
repository's ``tests/conftest.py`` imports JAX, which the port does not
need)::

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from randomprojection_tpu_torch.ops import fused_kernels as fk

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _x(n, d, seed=0, device="cuda"):
    g = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return torch.from_numpy(g).to(device)


@pytest.mark.parametrize(
    "seed,k,d,density,offset",
    [
        (0, 256, 4096, 1 / 3, 0),
        (12345678901, 256, 4100, 1 / 3, 0),   # ragged last block
        (2**32 - 5, 256, 4096, 1 / 3, 3),      # nonzero block offset
        (7, 8, 700, 0.05, 1),
        (2**31 + 3, 64, 1030, 1.0, 0),
    ],
)
def test_lazy_matrix_kernel_bit_exact(cuda, seed, k, d, density, offset):
    got = fk.rp_lazy_matrix(seed, k, d, density, block_offset=offset,
                            device=cuda)
    torch.cuda.synchronize()
    want = fk.lazy_matrix_plain(seed, k, d, density, block_offset=offset,
                                device=cuda)
    assert got.dtype == torch.float32 and got.shape == (k, d)
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["split2", "f32", "bf16"])
@pytest.mark.parametrize(
    "n,d,k,offset",
    [
        (1000, 1100, 64, 0),   # ragged rows, columns and k tile
        (257, 4096, 256, 2),
        (3, 520, 8, 0),
    ],
)
def test_fused_kernel_matches_plain(cuda, mode, n, d, k, offset):
    """max|Δ| ≤ 1e-5·max|Y|: the kernel sums in another order than the
    plain version's per-block float32 products."""
    x = _x(n, d, seed=n)
    if mode == "bf16":
        x = x.to(torch.bfloat16)
    y = fk.rp_fused_project(x, 11, k, 1 / 3, block_offset=offset,
                            mxu_mode=mode)
    torch.cuda.synchronize()
    ref = fk.fused_project(x, 11, k, 1 / 3, block_offset=offset,
                           mxu_mode=mode)
    assert y.shape == (n, k) and y.dtype == torch.float32
    err = (y - ref).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item(), err


def test_wrappers_dispatch_to_kernels_and_count(cuda):
    fk.reset_launches()
    x = _x(64, 600)
    y = fk.fused_sparse_project(x, 3, 16, 0.5, mxu_mode="split2")
    m = fk.lazy_matrix(3, 16, 600, 0.5, device=cuda)
    torch.cuda.synchronize()
    assert fk.LAUNCHES == {"rp_fused_project": 1, "rp_lazy_matrix": 1}
    ref = x.double() @ m.double().t()
    assert (y.double() - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def test_kernel_rejects_wrong_dtype(cuda):
    with pytest.raises(ValueError, match="contiguous 2-D"):
        fk.rp_fused_project(_x(8, 512).to(torch.bfloat16), 0, 8, 0.5,
                            mxu_mode="split2")
    with pytest.raises(ValueError, match="multiple of 8"):
        fk.rp_fused_project(_x(8, 512), 0, 12, 0.5)


# -- the estimators on the card ---------------------------------------------------


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize(
    "options",
    [
        {"materialization": "lazy"},
        {"materialization": "lazy", "precision": "default"},
        {},
        {"precision": "split2"},
        {"precision": "default"},
    ],
)
def test_card_routes_match_cpu_routes(cuda, options):
    import randomprojection_tpu_torch as rpt

    X = np.random.default_rng(5).normal(size=(300, 1100)).astype(np.float32)
    card = rpt.SparseRandomProjection(32, density=1 / 3, random_state=4,
                                      backend_options=options).fit(X)
    cpu = rpt.SparseRandomProjection(
        32, density=1 / 3, random_state=4,
        backend_options=options | {"device": "cpu"}).fit(X)
    assert card._backend.device.type == "cuda"
    np.testing.assert_array_equal(card.components_as_numpy(),
                                  cpu.components_as_numpy())
    got, want = card.transform(X), cpu.transform(X)
    assert got.dtype == np.float32
    # 'default' rounds x to bf16 on both, and its sums differ in order
    tol = 1e-3 if options.get("precision") == "default" else 1e-5
    assert _rel(got, want) <= tol
    y = card.transform(torch.from_numpy(X).cuda())
    assert y.is_cuda and y.dtype == torch.float32
    Xr = card.inverse_transform(y)
    assert Xr.is_cuda and Xr.shape == (300, 1100)
    # a CPU tensor given to the card backend comes back on the CPU
    y_cpu = card.transform(torch.from_numpy(X))
    assert y_cpu.device.type == "cpu"
    assert torch.equal(y_cpu, y.cpu())


def test_card_lazy_transform_counts_one_launch_per_batch(cuda):
    import randomprojection_tpu_torch as rpt

    X = torch.randn(1000, 600, device=cuda)
    est = rpt.SparseRandomProjection(
        16, density=0.5, random_state=0,
        backend_options={"materialization": "lazy"}).fit(X)
    fk.reset_launches()
    ys = [est.transform(X[lo:lo + 256]) for lo in range(0, 1000, 256)]
    torch.cuda.synchronize()
    assert fk.LAUNCHES["rp_fused_project"] == 4
    # row tiles are independent: batching does not change a bit
    assert torch.equal(torch.cat(ys), est.transform(X))


def test_card_stream_resume_bit_identical(cuda, tmp_path):
    import randomprojection_tpu_torch as rpt
    from randomprojection_tpu_torch import streaming

    def read(lo, hi):
        return np.random.default_rng(lo).normal(size=(hi - lo, 700)).astype(
            np.float32)

    src = streaming.CallableSource(read, 1000, 700, np.float32, batch_rows=128)
    est = rpt.SparseRandomProjection(
        16, density=1 / 3, random_state=2,
        backend_options={"materialization": "lazy"}).fit_source(src)
    full = streaming.stream_to_array(est, src)
    ckpt = str(tmp_path / "c.json")
    out = np.zeros_like(full)
    for i, (lo, y) in enumerate(est.transform_stream(src, checkpoint_path=ckpt)):
        out[lo:lo + y.shape[0]] = y
        if i == 2:
            break
    streaming.stream_to_array(est, src, out=out, checkpoint_path=ckpt)
    np.testing.assert_array_equal(out, full)
    rows = np.concatenate([read(lo, min(lo + 128, 1000))
                           for lo in range(0, 1000, 128)])
    np.testing.assert_array_equal(full, est.transform(rows))
