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
        (1, 4097, 512, 0),     # one row, odd d (cp.async; bf16 padded), 2 slices
        (3, 4097, 64, 2),
        (130, 1100, 8, 2),     # bf16 rows of 2200 bytes: the cp.async route
        (8517, 1024, 256, 0),  # 134 tiles: the persistent grid's second pass
        (20_000, 520, 512, 1),  # 626 tiles of 2 slices
    ],
)
def test_fused_kernel_matches_plain(cuda, mode, n, d, k, offset):
    """max|Δ| ≤ 1e-5·max|Y|: the kernel sums each 512-column block on the
    tensor cores and the blocks in float32, the plain version each block
    as one float32 product."""
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


def test_fused_kernel_rows_do_not_depend_on_their_tile(cuda):
    """A row's output is the same bits at any place in a tile and in any
    batch: no split of d, no atomics, no n-dependent tiling."""
    x = _x(300, 1100, seed=9)
    for mode in ("split2", "f32", "bf16"):
        xin = x.to(torch.bfloat16) if mode == "bf16" else x
        whole = fk.rp_fused_project(xin, 4, 64, 1 / 3, mxu_mode=mode)
        for lo, hi in ((5, 300), (63, 64), (100, 101), (37, 250)):
            part = fk.rp_fused_project(xin[lo:hi].contiguous(), 4, 64, 1 / 3,
                                       mxu_mode=mode)
            assert torch.equal(part, whole[lo:hi]), (mode, lo, hi)


def test_mask_cache_is_the_plain_mask(cuda):
    for seed, k, d, off in ((0, 256, 4096, 0), (7, 8, 700, 3),
                            (2**32 - 5, 264, 1100, 1)):
        got = fk.rp_mask_cache(seed, k, d, 1 / 3, block_offset=off,
                               device=cuda)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16 and got.shape[1] % 64 == 0
        want = fk.mask_cache_plain(seed, k, d, 1 / 3, block_offset=off,
                                   device=cuda)
        assert torch.equal(got, want)


def test_fused_kernel_smem_formula_matches_the_source(cuda):
    lib = fk._lib()
    for cta_n in (64, 128, 256):
        for mode, code in fk._MODE_CODES.items():
            for stages in range(2, fk.MAX_STAGES + 1):
                assert lib.rp_fused_smem_bytes(cta_n, code, stages) == \
                    fk.project_smem_bytes(cta_n, mode, stages)


def test_wrappers_dispatch_to_kernels_and_count(cuda):
    fk.reset_launches()
    x = _x(64, 600)
    y = fk.fused_sparse_project(x, 3, 16, 0.5, mxu_mode="split2")
    m = fk.lazy_matrix(3, 16, 600, 0.5, device=cuda)
    torch.cuda.synchronize()
    assert fk.LAUNCHES == {"rp_fused_project": 1, "rp_lazy_matrix": 1,
                           "rp_mask_cache": 1}
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
    assert fk.LAUNCHES["rp_mask_cache"] == 4  # the mask cache of each batch
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


# -- the top-k kernel --------------------------------------------------------------

# (queries, rows, bytes a row, m, tombstones, corpus, real rows): ragged
# query tiles and row tiles throughout
TOPK_SHAPES = [
    (37, 1000, 32, 40, 100, "dup", 997),         # ties from duplicated rows
    (300, 5000, 3, 16, 0, "random", 4997),       # 3-byte (20-bit) codes: byte loads
    (5, 128, 1 << 16, 16, 0, "random", 125),     # very wide rows, 2048 k-steps
    (20, 100, 8, 150, 10, "random", 97),         # m above the rows: lists never fill
    (3, 2000, 32, 1024, 0, "random", 1997),      # MAX_M (the popc route's alone)
    (130, 70_000, 32, 16, 700, "ties", 69_997),  # many splits, 3 distinct codes
    (4, 60, 32, 5, 60, "random", 57),            # every row deleted
    (65, 3000, 32, 10, 0, "descending", 3000),   # every row beats the list; nq = 65
    (1, 3000, 32, 1, 0, "equal", 3000),          # all rows equal; nq = 1, m = 1
    (5, 3000, 32, 10, 0, "equal", 3000),         # ... and ties inside one tile
    (70, 20_000, 32, 16, 19_800, "random", 20_000),  # 99% of the rows deleted
    (9, 500, 32, 7, 0, "random", 0),             # n_real = 0: every slot empty
    (33, 2000, 4, 10, 5, "random", 1990),        # 4-byte rows: word loads
    (33, 2000, 36, 256, 5, "random", 1990),      # 36-byte rows, m = 256
    (40, 3000, 32, 16, 30, "off4", 2990),        # bases 4 bytes off 16: word loads
    (40, 3000, 32, 16, 30, "off1", 2990),        # bases 1 byte off: byte loads
]


def _off(t, by):
    """The same contiguous tensor at a base ``by`` bytes past an allocation's."""
    flat = torch.empty(t.numel() + 16, dtype=torch.uint8, device=t.device)
    out = flat[by: by + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def _topk_inputs(nq, rows, nb, n_dead, corpus, device):
    rng = np.random.default_rng(rows + nb)
    if corpus == "ties":
        basis = rng.integers(0, 256, size=(3, nb), dtype=np.uint8)
        B, A = basis[rng.integers(0, 3, rows)], basis[rng.integers(0, 3, nq)]
    elif corpus == "descending":
        # row r has its first n_bits - r·n_bits/rows bits set and the
        # queries are all zeros: every row is nearer than all before it
        ones = nb * 8 - (np.arange(rows) * nb * 8) // rows
        bits = (np.arange(nb * 8)[None, :] < ones[:, None]).astype(np.uint8)
        B = np.packbits(bits, axis=1, bitorder="little")
        A = np.zeros((nq, nb), np.uint8)
    else:
        B = rng.integers(0, 256, size=(rows, nb), dtype=np.uint8)
        A = rng.integers(0, 256, size=(nq, nb), dtype=np.uint8)
        if corpus == "dup":
            B[rows // 2: rows // 2 + 20] = B[0]
            A[0] = B[0]
        if corpus == "equal":
            B[:] = B[0]
    if nb == 3:
        B[:, -1] &= 0x0F  # 20 bits: pad bits zero on both sides
        A[:, -1] &= 0x0F
    dead = None
    if n_dead:
        dead = np.zeros(rows, np.uint8)
        dead[rng.choice(rows, n_dead, replace=False)] = 1
        dead = torch.from_numpy(dead).to(device)
    q, codes = torch.from_numpy(A).to(device), torch.from_numpy(B).to(device)
    if corpus.startswith("off"):
        q, codes = _off(q, int(corpus[3:])), _off(codes, int(corpus[3:]))
    return q, codes, dead


@pytest.mark.parametrize("route", ["planned", "popc"])
@pytest.mark.parametrize("nq,rows,nb,m,n_dead,corpus,n_real", TOPK_SHAPES)
def test_topk_kernel_matches_plain(cuda, nq, rows, nb, m, n_dead, corpus,
                                   n_real, route):
    from randomprojection_tpu_torch.ops import topk_kernels as tk

    q, codes, dead = _topk_inputs(nq, rows, nb, n_dead, corpus, cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = tk.plan_fused(nq, rows, nb, m, sm_count=sms)
    # the tensor-core route takes every shape whose lists fit its block
    fits = tk.smem_bytes("wgmma", 64, m, 2, nb) <= 232_448
    assert plan.route == ("wgmma" if fits else "popc") and fits == (m < 1024)
    if route == "popc":
        plan = tk._plan_popc(nq, rows, m, sms)
    tk.reset_launches()
    d, i = tk.rp_fused_topk(q, codes, n_real, m, dead=dead, plan=plan)
    torch.cuda.synchronize()
    want = {"rp_fused_topk_wgmma": 0, "rp_fused_topk_popc": 0,
            "rp_topk_merge": 1}
    want[f"rp_fused_topk_{plan.route}"] = 1  # one scan and the merge
    assert tk.LAUNCHES == want
    wd, wi = tk.topk_plain(q, codes, n_real, m, dead=dead)
    assert d.shape == (nq, m) and d.dtype == i.dtype == torch.int32
    assert torch.equal(d, wd) and torch.equal(i, wi)
    if route == "planned":  # the public wrapper takes the same route
        fd, fi = tk.fused_topk(q, codes, n_real, m, dead=dead)
        assert torch.equal(fd, wd) and torch.equal(fi, wi)


def test_topk_kernel_smem_formula_matches_the_source(cuda):
    from randomprojection_tpu_torch.ops import topk_kernels as tk

    lib = tk._lib()
    for tq in (16, 32, 64):
        for m in (1, 16, 1024):
            assert lib.rp_topk_smem_bytes(0, tq, m, 0, 32) == \
                tk.smem_bytes("popc", tq, m)
    for tq in (64, 128):
        for m in (1, 16, 370):
            for stages in (2, 5, 8):
                for nb in (3, 32, 36):
                    assert lib.rp_topk_smem_bytes(1, tq, m, stages, nb) == \
                        tk.smem_bytes("wgmma", tq, m, stages, nb)


def test_topk_kernel_refuses_m_past_its_plan(cuda):
    from randomprojection_tpu_torch.models import sketch as sk
    from randomprojection_tpu_torch.ops import topk_kernels as tk

    q, codes, _ = _topk_inputs(3, 2000, 32, 0, "random", cuda)
    tk.reset_launches()
    with pytest.raises(ValueError, match=f"MAX_M={tk.MAX_M}"):
        tk.fused_topk(q, codes, 2000, tk.MAX_M + 1)
    with pytest.raises(ValueError, match=f"MAX_M={tk.MAX_M}"):
        sk.SimHashIndex(codes).query_topk(q, tk.MAX_M + 1)
    assert not any(tk.LAUNCHES.values())


# -- the serving path on the card ------------------------------------------------


def test_query_topk_launches_the_kernel_per_tile_chunk_and_pass(cuda):
    from randomprojection_tpu_torch.models import sketch as sk
    from randomprojection_tpu_torch.ops import topk_kernels as tk

    rng = np.random.default_rng(3)
    parts = [rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
             for n in (5000, 700)]
    A = rng.integers(0, 256, size=(300, 32), dtype=np.uint8)
    card = sk.SimHashIndex(parts[0])
    cpu = sk.SimHashIndex(parts[0], device="cpu")
    for idx in (card, cpu):
        idx.add(parts[1])
        idx.delete([0, 9, 5001])
    assert card.device.type == "cuda"
    tk.reset_launches()
    got = card.query_topk(A, 16, tile=128)  # 3 tiles x 2 chunks, scan + merge
    assert tk.LAUNCHES == {"rp_fused_topk_wgmma": 6, "rp_fused_topk_popc": 0,
                           "rp_topk_merge": 6}
    want = cpu.query_topk(A, 16, tile=128)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # queries already on the card give the same answer
    got_t = card.query_topk(torch.from_numpy(A).to(cuda), 16, tile=128)
    np.testing.assert_array_equal(got_t[1], want[1])
    with sk.TopKServer(card, 16, name="card-test") as srv:
        d, i = srv.query(A[:37])
    np.testing.assert_array_equal(i, want[1][:37])


def test_sign_codes_on_the_card_match_the_cpu(cuda):
    import randomprojection_tpu_torch as rpt

    X = np.random.default_rng(6).normal(size=(1000, 768)).astype(np.float32)
    card = rpt.SignRandomProjection(256, random_state=7).fit(X)
    cpu = rpt.SignRandomProjection(256, random_state=7,
                                   backend_options={"device": "cpu"}).fit(X)
    got, want = card.transform(X), cpu.transform(X)
    assert got.dtype == np.uint8 and got.shape == (1000, 32)
    y = X.astype(np.float64) @ cpu.components_as_numpy().astype(np.float64).T
    diff = np.unpackbits(got ^ want, axis=1, bitorder="little").astype(bool)
    # bits may differ only where |y| ≤ 1e-5·max|y|: sums in another order
    assert not (diff & (np.abs(y) > 1e-5 * np.abs(y).max())).any()
    codes = card.transform(torch.from_numpy(X).to(cuda))
    assert codes.is_cuda and codes.dtype == torch.uint8


# -- the LSH probe kernel and the LSH tier -------------------------------------


def _probe_inputs(rows, nb, bands, band_bits, tq, masks, seed, *, dup=0,
                  inactive=(), device="cuda"):
    """A banded CSR of random codes (``dup`` leading rows equal, for a long
    run) and a tile of query keys, as the kernel takes them."""
    from randomprojection_tpu_torch.ann import lsh

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 256, size=(rows, nb), dtype=np.uint8)
    codes[:dup] = codes[0]
    plan = lsh.BandPlan(nb * 8, bands=bands, band_bits=band_bits)
    b = lsh.BandedBuckets(plan)
    b.add(codes)
    q = rng.integers(0, 256, size=(tq, nb), dtype=np.uint8)
    q[: tq // 2] = codes[rng.integers(0, rows, tq // 2)]
    active = np.ones((1, tq), np.int32)
    active[0, list(inactive)] = 0
    planes = (lsh.band_keys(q, plan).astype(np.int32),
              np.asarray(masks, np.int32)[None, :], active,
              np.stack([ip.astype(np.int32) for ip in b._indptr]),
              np.stack(b._ids))
    return [torch.from_numpy(np.ascontiguousarray(p)).to(device) for p in planes]


# (rows, bytes, bands, band_bits, queries, masks, cap, repeated rows,
# inactive queries)
PROBE_SHAPES = [
    (5000, 8, 4, 8, 37, [0, 1, 2, 4, 8], 1 << 16, 0, (3, 36)),  # ragged tile
    (5000, 8, 4, 8, 37, [0, 1, 2, 4, 8], 1000, 0, ()),          # overflow
    (100, 8, 4, 12, 16, [0, 1, 2], 4096, 0, ()),                # empty buckets
    (4000, 8, 2, 8, 8, [0, 1], 1 << 15, 3000, (1,)),            # runs of 3000
    (300, 8, 3, 2, 9, [0, 1, 2, 3, 0, 1, 2], 1 << 14, 0, ()),   # P > 2^b
    (1 << 16, 8, 3, 20, 64, [0, 1, 2, 4], 1 << 14, 0, (0,)),    # b = 20
    (1000, 16, 16, 8, 1024, list(range(128)), 1 << 24, 0, ()),  # 2^21 runs
]


@pytest.mark.parametrize("rows,nb,bands,b,tq,masks,cap,dup,inactive",
                         PROBE_SHAPES)
def test_probe_kernel_matches_plain(cuda, rows, nb, bands, b, tq, masks, cap,
                                    dup, inactive):
    from randomprojection_tpu_torch.ops import probe_kernels as pk

    planes = _probe_inputs(rows, nb, bands, b, tq, masks, rows + tq, dup=dup,
                           inactive=inactive)
    pk.reset_launches()
    got = pk.probe_gather(*planes, cap=cap)
    torch.cuda.synchronize()
    assert pk.LAUNCHES == {"rp_probe": 2}  # the runs, then the copy
    want = pk.probe_plain(*planes, cap=cap)
    # the same algorithm: bit for bit, overflow included
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g, w)


def test_probe_kernel_is_stable_over_repeats(cuda):
    """2^21 runs (2048 blocks of 1,024 runs, four a thread) and 2^24 slots:
    200 launches give the same bits as the first."""
    from randomprojection_tpu_torch.ops import probe_kernels as pk

    rows, nb, bands, b, tq, masks, cap, dup, inactive = PROBE_SHAPES[-1]
    planes = _probe_inputs(rows, nb, bands, b, tq, masks, rows + tq)
    first = pk.rp_probe_gather(*planes, cap=cap)
    for _ in range(200):
        got = pk.rp_probe_gather(*planes, cap=cap)
        assert all(torch.equal(g, f) for g, f in zip(got, first))
    assert all(torch.equal(f, w) for f, w in
               zip(first, pk.probe_plain(*planes, cap=cap)))


def _graph_index(seed=8):
    from randomprojection_tpu_torch.ann import LSHSimHashIndex

    rng = np.random.default_rng(seed)
    parts = [rng.integers(0, 256, size=(n, 8), dtype=np.uint8)
             for n in (3000, 1200)]
    A = np.concatenate([parts[0][:40], rng.integers(0, 256, size=(60, 8),
                                                    dtype=np.uint8)])
    idx = LSHSimHashIndex(parts[0], bands=4, band_bits=8, probes=4,
                          fallback_density=1.0)
    idx.add(parts[1])
    idx.delete([0, 1, 2999, 3000, 3001])
    return idx, A, parts


@pytest.mark.parametrize("rows,cap", [(32, None), (32, 1 << 16), (13, None)],
                         ids=["planned cap", "unplanned cap", "ragged tile"])
def test_graph_replay_equals_the_eager_composite(cuda, rows, cap):
    from randomprojection_tpu_torch.ops import probe_kernels as pk

    idx, A, _ = _graph_index()
    masks = idx._probe_masks(4)
    if cap is None:
        cap = idx._lsh_device_cap(A[:rows], masks, 7)
    indptr, ids = idx._lsh_device_csr()
    rest = (indptr, ids, idx._lsh_device_dead(), idx._lsh_chunk_planes())
    mdev = idx._lsh_device_masks(masks)
    act = torch.ones((1, rows), dtype=torch.int32, device=cuda)
    act[0, 1] = 0
    tiles = [torch.from_numpy(A[lo: lo + rows]).to(cuda) for lo in (0, 50)]
    pk.reset_launches()
    entry = pk.capture_tile(tiles[0], mdev, act, *rest, 7, cap=cap,
                            band_bits=8)
    assert pk.GRAPH_CAPTURES == 1 and pk.LAUNCHES == {"rp_probe": 2}
    # two tiles of one key in flight: each replay's copies are queued
    # behind it, before the next replay overwrites the outputs
    fetched = []
    for t in tiles:
        fetched.append([o.to("cpu", non_blocking=True)
                        for o in entry.replay(t, mdev, act)])
    torch.cuda.synchronize()
    assert pk.GRAPH_REPLAYS == 2 and pk.LAUNCHES == {"rp_probe": 6}
    for k, t in enumerate(tiles):
        eager = pk.device_probe_topk(t, mdev, act, *rest, 7, cap=cap,
                                     band_bits=8)
        if k == 0:
            eager = entry.warmup
        for g, w in zip(fetched[k], eager):
            assert torch.equal(g, w.cpu())


def test_graph_replay_equals_the_host_rung_across_mutations(cuda):
    from randomprojection_tpu_torch.ops import probe_kernels as pk

    idx, A, parts = _graph_index(12)

    def check():
        pk.reset_launches()
        dev = idx.query_topk(A, 7, tile=32)
        # 4 tiles (the last one ragged): one replay each
        assert pk.GRAPH_REPLAYS == 4
        assert pk.LAUNCHES["rp_probe"] == 2 * (4 + pk.GRAPH_CAPTURES)
        host = idx.query_topk(A, 7, tile=32, probe_path="host")
        np.testing.assert_array_equal(dev[0], host[0])
        np.testing.assert_array_equal(dev[1], host[1])
        return pk.GRAPH_CAPTURES

    assert check() == 2  # a full-tile key and a ragged one
    assert check() == 0
    idx.add(parts[0][:500])
    assert check() == 2
    idx.delete(np.arange(100, 4000, 7))
    assert check() == 2
    idx.compact()
    assert check() == 2
    assert len(idx._lsh_graphs) == 2


def test_lsh_device_rung_equals_host_rung_on_the_card(cuda):
    from randomprojection_tpu_torch.ann import LSHSimHashIndex
    from randomprojection_tpu_torch.models import sketch as sk
    from randomprojection_tpu_torch.ops import probe_kernels as pk
    from randomprojection_tpu_torch.ops import topk_kernels as tk

    rng = np.random.default_rng(8)
    parts = [rng.integers(0, 256, size=(n, 8), dtype=np.uint8)
             for n in (3000, 1200)]
    A = np.concatenate([parts[0][:40], rng.integers(0, 256, size=(60, 8),
                                                    dtype=np.uint8)])
    card = LSHSimHashIndex(parts[0], bands=4, band_bits=8, probes=4,
                           fallback_density=1.0)
    assert card.device.type == "cuda"
    card.add(parts[1])
    card.delete([0, 1, 2999, 3000, 3001])
    for captures in (2, 0):  # the first call captures a full and a ragged tile
        pk.reset_launches()
        tk.reset_launches()
        dev = card.query_topk(A, 7, tile=32)
        # 4 tiles, each one replay of 2 K5 launches, a scan and a merge; a
        # capture's eager warm-up launches as much once more
        assert pk.GRAPH_REPLAYS == 4 and pk.GRAPH_CAPTURES == captures
        assert pk.LAUNCHES["rp_probe"] == 2 * (4 + captures)
        assert tk.LAUNCHES["rp_fused_topk_wgmma"] == 4 + captures
        assert tk.LAUNCHES["rp_topk_merge"] == 4 + captures
    host = card.query_topk(A, 7, tile=32, probe_path="host")
    np.testing.assert_array_equal(dev[0], host[0])
    np.testing.assert_array_equal(dev[1], host[1])
    # full coverage: the answer of a brute force over the live codes
    full = card.query_topk(A, 7, tile=32, probes=256)
    live = np.concatenate(parts)
    D = sk.pairwise_hamming(A, live).astype(np.int64)
    D[:, [0, 1, 2999, 3000, 3001]] = 8 * 8 + 1
    order = np.argsort((D << 13) | np.arange(live.shape[0]), axis=1)[:, :7]
    np.testing.assert_array_equal(full[1], order.astype(np.int32))
    np.testing.assert_array_equal(full[0], np.take_along_axis(D, order, 1))
    ada = card.query_topk(A, 7, tile=32, probes=256, adaptive=True)
    np.testing.assert_array_equal(ada[1], full[1])


def test_lsh_unplanned_wide_bands_launch_the_probe_kernel(cuda):
    from randomprojection_tpu_torch.ann import LSHSimHashIndex
    from randomprojection_tpu_torch.ops import probe_kernels as pk
    from randomprojection_tpu_torch.utils import telemetry

    rng = np.random.default_rng(9)
    codes = rng.integers(0, 256, size=(20_000, 32), dtype=np.uint8)
    A = codes[rng.integers(0, 20_000, 96)] ^ np.uint8(4)
    card = LSHSimHashIndex(codes, bands=8, band_bits=20, fallback_density=1.0)
    # 8 bands of 2^20 buckets: past the reference planner's TPU budget
    assert pk.plan_probe(32, 20_000, 8, 20, 16, 7) is None
    reg = telemetry.registry()
    for adaptive in (False, True):
        f0 = reg.counter("index.lsh.fallbacks")
        pk.reset_launches()
        dev = card.query_topk(A, 7, tile=32, probes=16, adaptive=adaptive)
        # every tile (every round, adaptive) is one replay
        assert pk.GRAPH_REPLAYS >= 3
        assert pk.LAUNCHES["rp_probe"] == 2 * (pk.GRAPH_REPLAYS
                                               + pk.GRAPH_CAPTURES)
        assert reg.counter("index.lsh.fallbacks") == f0
    host = card.query_topk(A, 7, tile=32, probes=16, probe_path="host")
    dev = card.query_topk(A, 7, tile=32, probes=16)
    np.testing.assert_array_equal(dev[0], host[0])
    np.testing.assert_array_equal(dev[1], host[1])
