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


@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("seed", [0, 2**32 - 5, 12345678901])
@pytest.mark.parametrize("k", [8, 512])
@pytest.mark.parametrize("d", [1, 3, 4097, 4099, 4100])
def test_mask_writer_trouble_shapes(cuda, d, k, seed, offset):
    """Both instantiations of the mask writer bit for bit against their
    plain versions: one column, a ragged run, float32 rows of odd width
    (single stores), of even width (pairs) and of d % 4 == 0 (16 bytes)."""
    got = fk.rp_lazy_matrix(seed, k, d, 1 / 3, block_offset=offset,
                            device=cuda)
    cache = fk.rp_mask_cache(seed, k, d, 1 / 3, block_offset=offset,
                             device=cuda)
    torch.cuda.synchronize()
    assert torch.equal(got, fk.lazy_matrix_plain(
        seed, k, d, 1 / 3, block_offset=offset, device=cuda))
    assert torch.equal(cache, fk.mask_cache_plain(
        seed, k, d, 1 / 3, block_offset=offset, device=cuda))


def test_mask_writer_loops_rows_past_the_grid(cuda):
    """k = 600,000 rows of 3 columns: past the grid's 65,535 × 8 rows, so
    threads step on by the grid's rows."""
    k, d = 600_000, 3
    assert fk.plan_mask_writer(k, d, 4).grid_y == fk.MAX_GRID_Y
    got = fk.rp_lazy_matrix(5, k, d, 0.5, device=cuda)
    cache = fk.rp_mask_cache(5, k, d, 0.5, device=cuda)
    torch.cuda.synchronize()
    assert torch.equal(got, fk.lazy_matrix_plain(5, k, d, 0.5, device=cuda))
    assert torch.equal(cache, fk.mask_cache_plain(5, k, d, 0.5, device=cuda))


@pytest.mark.parametrize("mode", ["split2", "f32", "bf16"])
@pytest.mark.parametrize("n,steps", [(70, 3), (1000, 16), (5, 99), (257, 7)])
def test_chain_equals_separate_launches(cuda, mode, n, steps):
    """The chain on the card: bit for bit the launches on its row split
    (ragged last block; steps past the rows clamp to one row a block), in
    one mask cache and one persistent launch."""
    x = _x(n, 700, seed=n)
    if mode == "bf16":
        x = x.to(torch.bfloat16)
    per = -(-n // min(steps, n))
    fk.reset_launches()
    parts = [fk.fused_sparse_project(x[lo:lo + per], 13, 16, 0.25,
                                     mxu_mode=mode)
             for lo in range(0, n, per)]
    blocks = len(parts)
    assert blocks == fk.multistep_chain_length(n, steps)
    assert fk.LAUNCHES["rp_fused_project"] == blocks
    fk.reset_launches()
    got = fk.fused_project_multistep(x, 13, 16, 0.25, steps=steps,
                                     mxu_mode=mode)
    torch.cuda.synchronize()
    assert fk.LAUNCHES == {"rp_fused_project": 1, "rp_mask_cache": 1,
                           "rp_lazy_matrix": 0}
    assert torch.equal(got, torch.cat(parts))


def test_backend_chain_on_the_card_equals_one_step(cuda):
    import randomprojection_tpu_torch as rpt

    X = torch.randn(3000, 1100, device=cuda)
    ests = [rpt.SparseRandomProjection(
        32, density=1 / 3, random_state=4,
        backend_options={"materialization": "lazy", "dispatch_steps": k},
    ).fit(X) for k in (1, 16)]
    one = ests[0].transform(X)
    fk.reset_launches()
    chained = ests[1].transform(X)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["rp_fused_project"] == 1
    assert fk.LAUNCHES["rp_mask_cache"] == 1
    assert torch.equal(chained, one)
    Xh = X.cpu().numpy()
    np.testing.assert_array_equal(ests[1].transform(Xh), ests[0].transform(Xh))


def test_fused_kernel_shares_a_mask_and_writes_into_out(cuda):
    x = _x(300, 1100, seed=3)
    want = fk.rp_fused_project(x, 4, 64, 1 / 3)
    mask = fk.rp_mask_cache(4, 64, 1100, 1 / 3, device=cuda)
    out = torch.empty((300, 64), device=cuda)
    fk.reset_launches()
    got = fk.rp_fused_project(x, 4, 64, 1 / 3, mask=mask, out=out)
    torch.cuda.synchronize()
    assert got.data_ptr() == out.data_ptr() and torch.equal(got, want)
    assert fk.LAUNCHES["rp_mask_cache"] == 0
    with pytest.raises(ValueError, match="mask must be"):
        fk.rp_fused_project(x, 4, 64, 1 / 3, mask=mask[:, :64])
    with pytest.raises(ValueError, match="out must be"):
        fk.rp_fused_project(x, 4, 64, 1 / 3, out=out[:10])


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


# (corpus, tombstones, real rows) at 70 queries over 514 row tiles of 256:
# equal distances across every split boundary, tombstones, and real rows
# that end short of the rows, leaving the last splits empty
SPLIT_CASES = [("ties", 1000, 514 * 256 - 5), ("equal", 300, 200 * 256 + 3),
               ("dup", 40, 514 * 256)]


@pytest.mark.parametrize("splits", [33, 132, 257])
@pytest.mark.parametrize("m", [1, 16, 40])
@pytest.mark.parametrize("corpus,n_dead,n_real", SPLIT_CASES)
@pytest.mark.parametrize("route", ["wgmma", "popc"])
def test_topk_kernel_takes_any_number_of_row_splits(cuda, route, corpus,
                                                    n_dead, n_real, m, splits):
    """A forced split count past the merge warp's 32 lanes, and not a
    multiple of 32: the same lists as the plain version, bit for bit, from
    one scan and one merge."""
    from randomprojection_tpu_torch.ops import topk_kernels as tk

    nq, rows = 70, 514 * 256
    q, codes, dead = _topk_inputs(nq, rows, 32, n_dead, corpus, cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = (tk.plan_fused(nq, rows, 32, m, sm_count=sms) if route == "wgmma"
            else tk._plan_popc(nq, rows, m, sms))
    assert plan.route == route
    n_tiles = -(-rows // plan.tile_rows)
    plan = plan._replace(splits=splits, tiles_per_split=-(-n_tiles // splits))
    tk.reset_launches()
    d, i = tk.rp_fused_topk(q, codes, n_real, m, dead=dead, plan=plan)
    torch.cuda.synchronize()
    want = {"rp_fused_topk_wgmma": 0, "rp_fused_topk_popc": 0,
            "rp_topk_merge": 1}
    want[f"rp_fused_topk_{route}"] = 1
    assert tk.LAUNCHES == want
    wd, wi = tk.topk_plain(q, codes, n_real, m, dead=dead)
    assert torch.equal(d, wd) and torch.equal(i, wi)


# (corpus, tombstones, real rows) at 70 queries over 514 row tiles of 256
# that stress the survivors' buffers: every distance equal (each tile
# overflows every buffer), distances falling in scan order (every row
# survives), the true neighbours in each split's last tile, tombstones and
# real rows that end short of the rows
BUFFER_CASES = [("equal", 0, 514 * 256), ("descending", 0, 514 * 256),
                ("last", 0, 514 * 256), ("equal", 300, 200 * 256 + 3),
                ("last", 2000, 514 * 256 - 77)]


def _route_max_m():
    """The largest m the tensor-core route takes at 32-byte rows."""
    from randomprojection_tpu_torch.ops import topk_kernels as tk

    return max(m for m in range(1, tk.MAX_M + 1)
               if tk.smem_bytes("wgmma", 64, m, 2, 32) <= 232_448)


@pytest.mark.parametrize("splits", [1, 33, 132, 257])
@pytest.mark.parametrize("m", [1, 10, 16, 32, 33, 40, "max"])
@pytest.mark.parametrize("corpus,n_dead,n_real", BUFFER_CASES)
def test_topk_buffers_keep_the_exact_lists(cuda, corpus, n_dead, n_real, m,
                                           splits):
    """The tensor-core scan's buffers and merges against the plain top-m,
    bit for bit, at forced split counts, for m on both sides of a warp's
    32 lanes up to the route's largest."""
    from randomprojection_tpu_torch.ops import topk_kernels as tk

    m = _route_max_m() if m == "max" else m
    nq, rows = 70, 514 * 256
    q, codes, dead = _topk_inputs(nq, rows, 32, n_dead,
                                  "random" if corpus == "last" else corpus, cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = tk.plan_fused(nq, rows, 32, m, sm_count=sms)
    assert plan.route == "wgmma"
    tps = -(-514 // splits)
    plan = plan._replace(splits=-(-514 // tps), tiles_per_split=tps)
    if corpus == "last":
        # each split's last tile holds every query's near copies
        g = torch.Generator(device=cuda).manual_seed(splits + m)
        for s in range(plan.splits):
            t = min((s + 1) * tps, 514) - 1
            near = q.repeat(4, 1)[: 256]
            flip = torch.randint(0, 256, near.shape, generator=g, device=cuda,
                                 dtype=torch.uint8) & torch.randint(
                0, 256, near.shape, generator=g, device=cuda,
                dtype=torch.uint8) & 0x11
            codes[t * 256: t * 256 + near.shape[0]] = near ^ flip
    d, i = tk.rp_fused_topk(q, codes, n_real, m, dead=dead, plan=plan)
    torch.cuda.synchronize()
    wd, wi = tk.topk_plain(q, codes, n_real, m, dead=dead)
    assert torch.equal(d, wd) and torch.equal(i, wi)


def test_topk_survivor_counts_equal_a_host_count_of_the_scan(cuda):
    """The keys the scan's rows buffered, its merges, the row-tiles it
    tested and those its shared bound tightened, as the kernel adds them
    up, equal ``mma_scan_plain``'s count of the same scan, with the bound
    seeded at each query's m-th distance: no list's merge lowers it then,
    so the counts do not hang on the order in which the splits' blocks
    run.  The lists equal the plain top-m."""
    from randomprojection_tpu_torch.ops import topk_kernels as tk

    nq, rows, m = 40, 20_000, 16
    q, codes, dead = _topk_inputs(nq, rows, 32, 300, "random", cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = tk.plan_fused(nq, rows, 32, m, sm_count=sms)
    plan = plan._replace(splits=3, tiles_per_split=27)
    wd, wi = tk.topk_plain(q, codes, rows - 9, m, dead=dead)
    seed = wd[:, -1].contiguous()
    bound = seed.clone()
    counts = torch.zeros(4, dtype=torch.int64, device=cuda)
    d, i = tk.rp_fused_topk(q, codes, rows - 9, m, dead=dead, plan=plan,
                            counts=counts, bound=bound)
    torch.cuda.synchronize()
    host_bound = seed.cpu().numpy().astype(np.int64)
    part, keys, merges, row_tiles, tight = tk.mma_scan_plain(
        q.cpu(), codes.cpu(), rows - 9, m, plan, dead=dead.cpu(),
        bound=host_bound)
    assert counts.tolist() == [keys, merges, row_tiles, tight]
    assert torch.equal(bound, seed) and (host_bound == seed.cpu().numpy()).all()
    _, keys0, _, _, _ = tk.mma_scan_plain(q.cpu(), codes.cpu(), rows - 9, m,
                                          plan, dead=dead.cpu())
    assert nq * m <= keys < keys0 and merges >= nq
    assert row_tiles == nq * 79 and 0 < tight <= row_tiles
    assert torch.equal(d, wd) and torch.equal(i, wi)


def _planted_copies(q, codes, m, first, seed):
    """Each query's m near copies (a few bits flipped) at rows from
    ``first`` on."""
    g = torch.Generator(device=q.device).manual_seed(seed)
    near = q.repeat_interleave(m, dim=0)
    flip = torch.randint(0, 256, near.shape, generator=g, device=q.device,
                         dtype=torch.uint8) & torch.randint(
        0, 256, near.shape, generator=g, device=q.device,
        dtype=torch.uint8) & 0x11
    codes[first: first + near.shape[0]] = near ^ flip


def test_a_fresh_bound_takes_fewer_keys_and_keeps_the_lists(cuda):
    """The launch's own bound on planted codes over many splits: the
    answer is the plain top-m, and the splits take fewer keys than the
    same scan with no bound (``mma_scan_plain``); the bound binds at some
    row-tiles."""
    from randomprojection_tpu_torch.ops import topk_kernels as tk

    nq, rows, m = 40, 160 * 256, 16
    q, codes, _ = _topk_inputs(nq, rows, 32, 0, "random", cuda)
    _planted_copies(q, codes, m, 3 * 256, 5)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = tk.plan_fused(nq, rows, 32, m, sm_count=sms)
    plan = plan._replace(splits=40, tiles_per_split=4)
    counts = torch.zeros(4, dtype=torch.int64, device=cuda)
    d, i = tk.rp_fused_topk(q, codes, rows, m, plan=plan, counts=counts)
    torch.cuda.synchronize()
    wd, wi = tk.topk_plain(q, codes, rows, m)
    assert torch.equal(d, wd) and torch.equal(i, wi)
    _, keys0, _, rows0, tight0 = tk.mma_scan_plain(q.cpu(), codes.cpu(), rows,
                                                   m, plan)
    keys, _, row_tiles, tight = counts.tolist()
    assert keys < keys0 and row_tiles == rows0 == nq * 160 and tight0 == 0
    assert 0 < tight < row_tiles


# (where each query's m near copies lie, tombstones, real rows) at 70
# queries over 514 row tiles of 256: in the first split, in the last, and
# across the boundary of the first two
BOUND_CASES = [("first", 0, 514 * 256), ("last", 500, 514 * 256 - 77),
               ("boundary", 0, 514 * 256 - 300)]


@pytest.mark.parametrize("splits", [2, 33, 132, 257])
@pytest.mark.parametrize("m", [1, 10, 16, "max"])
@pytest.mark.parametrize("where,n_dead,n_real", BOUND_CASES)
def test_a_shared_bound_keeps_the_exact_lists(cuda, where, n_dead, n_real, m,
                                              splits):
    """The bound the row splits share, engaged at forced split counts:
    the plain top-m bit for bit wherever the near copies lie, with
    tombstones and real rows that end short."""
    from randomprojection_tpu_torch.ops import topk_kernels as tk

    m = _route_max_m() if m == "max" else m
    nq, rows = 70, 514 * 256
    q, codes, dead = _topk_inputs(nq, rows, 32, n_dead, "random", cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = tk.plan_fused(nq, rows, 32, m, sm_count=sms)
    tps = -(-514 // splits)
    plan = plan._replace(splits=-(-514 // tps), tiles_per_split=tps)
    copies = nq * min(m, 16)
    first = {"first": 0, "last": (plan.splits - 1) * tps * 256,
             "boundary": tps * 256 - copies // 2}[where]
    _planted_copies(q, codes, min(m, 16), min(first, n_real - copies), m)
    d, i = tk.rp_fused_topk(q, codes, n_real, m, dead=dead, plan=plan)
    torch.cuda.synchronize()
    wd, wi = tk.topk_plain(q, codes, n_real, m, dead=dead)
    assert torch.equal(d, wd) and torch.equal(i, wi)


@pytest.mark.parametrize("splits", [33, 132, 257])
@pytest.mark.parametrize("m", [1, 10, 16, "max"])
def test_equal_distances_under_a_shared_bound_take_the_lowest_ids(cuda, m,
                                                                  splits):
    """Every distance equal over many splits: each split's full list
    publishes that distance, the other splits' keys tie with the bound and
    pass, and the answer is ids 0..m-1."""
    from randomprojection_tpu_torch.ops import topk_kernels as tk

    m = _route_max_m() if m == "max" else m
    nq, rows = 70, 514 * 256
    q, codes, _ = _topk_inputs(nq, rows, 32, 0, "equal", cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = tk.plan_fused(nq, rows, 32, m, sm_count=sms)
    tps = -(-514 // splits)
    plan = plan._replace(splits=-(-514 // tps), tiles_per_split=tps)
    d, i = tk.rp_fused_topk(q, codes, rows, m, plan=plan)
    torch.cuda.synchronize()
    assert torch.equal(i.cpu(), torch.arange(m, dtype=torch.int32).expand(nq, m))
    assert (d == d[:, :1]).all()


@pytest.mark.parametrize("nq,splits,m", [(64, 132, 16), (5, 4096, 16),
                                         (3, 30_000, 4), (2, 65_535, 2),
                                         (9, 40, 1024)])
def test_topk_merge_takes_any_number_of_lists(cuda, nq, splits, m):
    """The merge alone: ascending lists of distinct keys, with the empty
    slots' equal sentinel keys at their ends, merged into the m least,
    the sentinel written for an empty slot."""
    from randomprojection_tpu_torch.ops import topk_kernels as tk

    g = torch.Generator(device=cuda).manual_seed(nq + splits + m)
    n_bits = 256
    dist = torch.randint(0, n_bits + 1, (nq, splits, m), generator=g,
                         device=cuda, dtype=torch.int64)
    ids = torch.randperm(nq * splits * m, generator=g, device=cuda).view(
        nq, splits, m) % (1 << 31)
    keys = (dist << 32) | ids
    empty = ((n_bits + 1) << 32) | 0x7FFFFFFF
    fill = torch.randint(0, m + 1, (nq, splits, 1), generator=g, device=cuda)
    keys = keys.sort(dim=2).values
    keys = torch.where(torch.arange(m, device=cuda) < fill, keys, empty)
    part = keys.contiguous()
    d = torch.empty((nq, m), dtype=torch.int32, device=cuda)
    i = torch.empty_like(d)
    lib = tk._lib()
    rc = lib.rp_topk_merge(part.data_ptr(), nq, splits, m, n_bits // 8,
                           d.data_ptr(), i.data_ptr(),
                           torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    top = part.view(nq, -1).sort(dim=1).values[:, :m]
    gone = (top >> 32) > n_bits
    assert torch.equal(d.long(), torch.where(gone, n_bits + 1, top >> 32))
    assert torch.equal(i.long(), torch.where(gone, 0x7FFFFFFF,
                                             top & 0xFFFFFFFF))


def test_topk_kernel_refuses_splits_past_a_launch_grid(cuda):
    from randomprojection_tpu_torch.ops import topk_kernels as tk

    q, codes, _ = _topk_inputs(4, 3000, 32, 0, "random", cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = tk.plan_fused(4, 3000, 32, 16, sm_count=sms)
    tk.reset_launches()
    with pytest.raises(RuntimeError, match="launch failed"):
        tk.rp_fused_topk(q, codes, 3000, 16,
                         plan=plan._replace(splits=65_536, tiles_per_split=1))
    assert not any(tk.LAUNCHES.values())


def test_topk_kernel_smem_formula_matches_the_source(cuda):
    from randomprojection_tpu_torch.ops import topk_kernels as tk

    lib = tk._lib()
    for tq in (16, 32, 64):
        for m in (1, 16, 1024):
            assert lib.rp_topk_smem_bytes(0, tq, m, 0, 0, 32) == \
                tk.smem_bytes("popc", tq, m)
    for tq in (64, 128):
        for m in (1, 16, 361):
            for stages in (2, 5, 8):
                for nb in (3, 32, 36):
                    for buf in (8, 16, 32):
                        assert lib.rp_topk_smem_bytes(1, tq, m, stages, buf,
                                                      nb) == \
                            tk.smem_bytes("wgmma", tq, m, stages, nb, buf)


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
              np.stack(b.ids))
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
    tiles = [torch.from_numpy(A[lo: lo + rows]).to(cuda)
             for lo in (0, 50, 0)]
    pk.reset_launches()
    entry = pk.capture_tile(tiles[0], mdev, act, *rest, 7, cap=cap,
                            band_bits=8)
    assert pk.GRAPH_CAPTURES == 1 and pk.LAUNCHES == {"rp_probe": 2}
    # three tiles of one key in flight, the queries changed between them:
    # each replay's copies are queued behind it, before the next replay
    # overwrites the outputs, and each replay's re-rank starts from a fresh
    # shared bound (a bound left by the tile before would drop its keys)
    fetched = []
    for t in tiles:
        fetched.append([o.to("cpu", non_blocking=True)
                        for o in entry.replay(t, mdev, act)])
    torch.cuda.synchronize()
    assert pk.GRAPH_REPLAYS == 3 and pk.LAUNCHES == {"rp_probe": 8}
    for k, t in enumerate(tiles):
        eager = pk.device_probe_topk(t, mdev, act, *rest, 7, cap=cap,
                                     band_bits=8)
        if k == 0:
            eager = entry.warmup
        (gd, gg, gs, gc), (wd, wg, ws, wc) = fetched[k], eager
        assert torch.equal(gd, wd.cpu()) and torch.equal(gg, wg.cpu())
        assert torch.equal(gc, wc.cpu())
        # K5's stats exactly; the re-rank's counts (words 4-11) depend on
        # how its row splits' blocks interleave under the shared bound
        assert torch.equal(gs[:4], ws[:4].cpu())
        assert gs.shape == (pk.STATS_WORDS,)
        assert pk.rerank_counts(gs.numpy())[0] > 0


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


def _numpy_band_csr(codes, bands, band_bits):
    """The banded CSR by numpy alone, for the card's build to meet: a
    band's keys from the unpacked bits, a stable argsort (ids ascending
    within each bucket) and the indptr from a bincount."""
    keys = np.zeros((bands, codes.shape[0]), np.int64)
    for lo in range(0, codes.shape[0], 1 << 20):
        bits = np.unpackbits(codes[lo:lo + (1 << 20)], axis=1,
                             bitorder="little")
        w = 1 << np.arange(band_bits, dtype=np.int64)
        for j in range(bands):
            keys[j, lo:lo + (1 << 20)] = bits[
                :, j * band_bits:(j + 1) * band_bits] @ w
    for j in range(bands):
        counts = np.bincount(keys[j], minlength=1 << band_bits)
        yield (np.concatenate(([0], np.cumsum(counts))),
               np.argsort(keys[j], kind="stable"))


def test_lsh_card_built_csr_equals_the_host_build_at_2_24_codes(cuda):
    from randomprojection_tpu_torch.ann import LSHSimHashIndex

    g = torch.Generator(device=cuda)
    g.manual_seed(24)
    codes = torch.randint(0, 256, (1 << 24, 32), generator=g,
                          dtype=torch.uint8, device=cuda)
    codes[: 1 << 16] = codes[:1]  # one bucket of every band holds 65,536
    idx = LSHSimHashIndex(codes, bands=8, band_bits=20)
    ip, ids = idx._buckets.dev
    assert ip.is_cuda and ids.is_cuda and idx._buckets._ids is None
    ip, ids = ip.cpu().numpy(), ids.cpu().numpy()
    for j, (want_ip, want_ids) in enumerate(
            _numpy_band_csr(codes.cpu().numpy(), 8, 20)):
        np.testing.assert_array_equal(ip[j], want_ip)
        np.testing.assert_array_equal(idx._buckets._indptr[j], want_ip)
        np.testing.assert_array_equal(ids[j], want_ids)


def test_lsh_card_built_index_answers_as_the_host_build(cuda, tmp_path):
    from randomprojection_tpu_torch.ann import LSHSimHashIndex, load_lsh_index

    rng = np.random.default_rng(31)
    centres = rng.integers(0, 256, size=(2000, 32), dtype=np.uint8)
    codes = np.repeat(centres, 16, axis=0)
    codes[np.arange(codes.shape[0]), rng.integers(0, 32, codes.shape[0])] ^= 1
    A = codes[rng.integers(0, codes.shape[0], 200)] ^ np.uint8(2)
    kw = dict(bands=8, band_bits=20, probes=16, fallback_density=1.0)
    card = LSHSimHashIndex(torch.from_numpy(codes[:20000]).to(cuda), **kw)
    cpu = LSHSimHashIndex(codes[:20000], device="cpu", **kw)
    assert card._buckets.dev[1].is_cuda and not cpu._buckets.dev[1].is_cuda

    def same(n):
        for j, (want_ip, want_ids) in enumerate(
                _numpy_band_csr(card_codes(n), 8, 20)):
            np.testing.assert_array_equal(
                card._buckets.dev[0][j].cpu().numpy(), want_ip)
            np.testing.assert_array_equal(
                card._buckets.dev[1][j].cpu().numpy(), want_ids)
        for path in ("auto", "host"):
            got = card.query_topk(A, 10, tile=64, probe_path=path)
            want = cpu.query_topk(A, 10, tile=64, probe_path="host")
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])

    def card_codes(n):
        return np.concatenate([c.b.cpu().numpy() for c in card._chunks])[:n]

    same(20000)
    for idx in (card, cpu):
        idx.add(codes[20000:])
    assert card._buckets.dev[1].is_cuda and card._buckets.n == 32000
    same(32000)
    for idx in (card, cpu):
        idx.delete(np.arange(0, 32000, 3))
    same(32000)
    card.save(str(tmp_path / "snap"))
    back = load_lsh_index(str(tmp_path / "snap"))
    assert back._buckets.dev[1].is_cuda
    np.testing.assert_array_equal(back._buckets.keys, cpu._buckets.keys)
    np.testing.assert_array_equal(back.query_topk(A, 10, tile=64)[1],
                                  cpu.query_topk(A, 10, tile=64)[1])
    for idx in (card, cpu):
        idx.compact()
    assert card._buckets.dev[1].is_cuda and card._buckets.n == cpu.n_codes
    same(cpu.n_codes)


# -- the threefry matrices, snapshots and durable ingest on the card ------------


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


@pytest.mark.parametrize("seed", [0, 1, 2**32 - 5, 12345678901])
def test_threefry_matrices_on_the_card_equal_the_cpu(cuda, seed):
    from randomprojection_tpu_torch.ops import kernels, threefry

    key = threefry.fold_in(threefry.seed_key(seed, "cpu"), 0x5250)
    for k, d in ((256, 4096), (24, 700)):
        for density in (1 / 3, 1.0):
            assert torch.equal(
                kernels.sparse_matrix(key, k, d, density, device=cuda).cpu(),
                kernels.sparse_matrix(key, k, d, density),
            )
        assert torch.equal(
            kernels.rademacher_matrix(key, k, d, device=cuda).cpu(),
            kernels.rademacher_matrix(key, k, d),
        )
        # the Gaussian's stated tolerance (4 ulps): the card's float64
        # log1p is not the CPU's to the last bit
        assert _ulps(kernels.gaussian_matrix(key, k, d, device=cuda).cpu(),
                     kernels.gaussian_matrix(key, k, d)) <= 4


def test_backend_draws_the_same_matrix_on_the_card(cuda):
    import randomprojection_tpu_torch as port

    X = np.zeros((2, 1100), np.float32)
    for options in ({}, {"precision": "split2"}):
        card = port.SparseRandomProjection(
            32, density=0.25, random_state=3, backend_options=options).fit(X)
        cpu = port.SparseRandomProjection(
            32, density=0.25, random_state=3,
            backend_options={"device": "cpu", **options}).fit(X)
        np.testing.assert_array_equal(card.components_as_numpy(),
                                      cpu.components_as_numpy())


def test_snapshot_round_trip_on_the_card(cuda, tmp_path):
    from randomprojection_tpu_torch.models.sketch import SimHashIndex

    rng = np.random.default_rng(4)
    codes = rng.integers(0, 256, size=(9000, 32), dtype=np.uint8)
    live = SimHashIndex(codes[:6000])
    live.add(codes[6000:])
    live.delete(rng.integers(0, 9000, 90))
    q = codes[rng.integers(0, 9000, 64)] ^ np.uint8(1)
    live.save(str(tmp_path))
    back = SimHashIndex.load(str(tmp_path))
    assert back.device.type == "cuda" and len(back._chunks) == 2
    want = live.query_topk(q, 16)
    for got in (back.query_topk(q, 16),
                SimHashIndex.load(str(tmp_path), device="cpu").query_topk(q, 16)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_crash_child_on_the_card_resumes_bit_identical(cuda, tmp_path):
    from randomprojection_tpu_torch import durable

    verdict = durable.crash_smoke(str(tmp_path), rows=512, batch_rows=64,
                                  d=32, bits=64, device="cuda",
                                  points=("mid-batch",), nth=4, timeout=300)
    assert verdict["ok"], verdict


# -- tiered residency and CountSketch on the card ----------------------------------


def _tier_codes(rows, nb, seed):
    return np.random.default_rng(seed).integers(0, 256, size=(rows, nb),
                                                dtype=np.uint8)


def test_tier_cold_chunks_live_in_pinned_memory(cuda, tmp_path):
    from randomprojection_tpu_torch.models.sketch import SimHashIndex

    codes = _tier_codes(4000, 16, 20)
    idx = SimHashIndex(codes[:1000], hbm_budget_bytes=1000 * 16)
    try:
        for lo in range(1000, 4000, 1000):
            idx.add(codes[lo:lo + 1000])
        assert idx._chunks[0].b.is_cuda
        for c in idx._chunks[1:]:
            assert not c.b.is_cuda and c.b.is_pinned()
        assert idx._tier.demote(0)
        assert idx._chunks[0].b.is_pinned()
    finally:
        idx.close()


def test_stage_rows_lands_every_source_on_the_card(cuda, tmp_path):
    from randomprojection_tpu_torch.ops import topk_kernels as tk

    rows = _tier_codes(777, 24, 21)
    np.save(tmp_path / "c.npy", rows)
    mm = np.load(tmp_path / "c.npy", mmap_mode="r")
    pinned = torch.from_numpy(rows.copy()).pin_memory()
    for src, pad in ((rows, None), (mm, 1024), (pinned, None), (pinned, 800)):
        dev, ev = tk.stage_rows(src, device=cuda, pad_to=pad)
        tk.wait_staged(dev, ev)
        got = dev.cpu().numpy()
        np.testing.assert_array_equal(got[:777], rows)
        assert got.shape[0] == (pad or 777) and not got[777:].any()


def test_tier_demote_during_queries_stays_bit_exact(cuda):
    """The worker thread demotes and promotes chunks while the main thread
    serves: every answer equals the resident index's (a staged copy is
    waited for on the consuming stream, a demoted device tensor is never
    reused under a kernel that reads it)."""
    import threading

    from randomprojection_tpu_torch.models.sketch import SimHashIndex

    codes = _tier_codes(4 * 200_000, 32, 22)
    q = codes[np.random.default_rng(23).integers(0, codes.shape[0], 512)] ^ np.uint8(3)
    resident = SimHashIndex(codes)
    want = resident.query_topk(q, 16)
    tiered = SimHashIndex(codes[:200_000], hbm_budget_bytes=2 * 200_000 * 32)
    stop = threading.Event()
    try:
        for lo in range(200_000, codes.shape[0], 200_000):
            tiered.add(codes[lo:lo + 200_000])
        tier = tiered._tier

        def churn():
            entries = list(tier._entries)
            while not stop.is_set():
                for e in entries[:2]:
                    tier._demote(e)
                    tier._promote(e)

        t = threading.Thread(target=churn)
        t.start()
        for _ in range(12):
            got = tiered.query_topk(q, 16)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
        stop.set()
        t.join()
    finally:
        stop.set()
        tiered.close()


def test_tier_promotion_then_device_rung_is_bit_exact(cuda):
    from randomprojection_tpu_torch.ann import LSHSimHashIndex
    from randomprojection_tpu_torch.ops import probe_kernels as pk

    codes = _tier_codes(4 * 3000, 8, 24)
    A = codes[:64] ^ np.uint8(1)
    kw = dict(bands=4, band_bits=8, probes=4, fallback_density=1.0)
    resident = LSHSimHashIndex(codes, **kw)
    want = resident.query_topk(A, 7, tile=32)
    idx = LSHSimHashIndex(codes[:3000], hbm_budget_bytes=1 << 30, **kw)
    try:
        for lo in range(3000, codes.shape[0], 3000):
            idx.add(codes[lo:lo + 3000])
        idx._tier._maybe_rebalance = lambda: None  # residency moves by hand
        np.testing.assert_array_equal(idx.query_topk(A, 7, tile=32)[1], want[1])
        assert len(idx._lsh_graphs) > 0  # the device rung captured its tiles
        assert idx._tier.demote(3000)
        assert len(idx._lsh_graphs) == 0  # the demotion dropped them
        # a cold chunk: the device rung runs eager, K5 on the card and the
        # cold candidate rows staged
        pk.reset_launches()
        got = idx.query_topk(A, 7, tile=32)
        assert pk.LAUNCHES["rp_probe"] > 0 and pk.GRAPH_CAPTURES == 0
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        for p in (1, 1 << 8):
            np.testing.assert_array_equal(
                idx.query_topk(A, 7, tile=32, probes=p, adaptive=True)[1],
                resident.query_topk(A, 7, tile=32, probes=p, adaptive=True)[1])
        idx._tier._promote(idx._tier._entries[1])
        pk.reset_launches()
        got = idx.query_topk(A, 7, tile=32)
        assert pk.GRAPH_CAPTURES >= 1 and pk.GRAPH_REPLAYS == 2
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    finally:
        idx.close()


def test_tier_smoke_on_the_card(cuda):
    from randomprojection_tpu_torch import tier_smoke

    assert tier_smoke.main("cuda")["fallbacks"] > 0


# "docmajor" and "flat": CSR batches the reference sends down its two
# routes; the port serves both with its one flat route
@pytest.mark.parametrize("route", ["docmajor", "flat", "dense", "scatter"])
def test_countsketch_routes_on_the_card_match_the_cpu(cuda, route):
    import scipy.sparse as sp

    from randomprojection_tpu_torch.models.sketch import CountSketch

    rng = np.random.default_rng(25)
    X = rng.normal(size=(300, 5000)).astype(np.float32)
    X[np.abs(X) < 1.5] = 0.0
    if route == "flat":
        X[7, :] = rng.normal(size=5000)  # one wide row: the reference's flat
    Xin = X if route in ("dense", "scatter") else sp.csr_array(X)
    mxu = False if route == "scatter" else None
    card = CountSketch(64, random_state=3, use_mxu=mxu).fit(Xin)
    cpu = CountSketch(64, random_state=3, use_mxu=mxu,
                      backend_options={"device": "cpu"}).fit(Xin)
    host = CountSketch(64, random_state=3, backend="numpy").fit(Xin)
    y = card.transform(Xin)
    np.testing.assert_allclose(y, cpu.transform(Xin), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(y, host.transform(Xin), rtol=2e-5, atol=2e-5)
    if route in ("docmajor", "flat"):
        b = card.prepare_batch(Xin)
        # each operand in flight on the copy stream, with its event
        t = b.arrays[0].tensor
        assert t.is_cuda and t.numel() == Xin.nnz
        np.testing.assert_allclose(card._transform_async(b).cpu().numpy(), y,
                                   rtol=2e-5, atol=2e-5)


# -- uploads from a producer thread (streaming) ----------------------------------


def _serial_and(ingest, est, X, batch, consume=None):
    """The serial stream's output and the stream through ``ingest`` (a
    function of the inner source), the latter consumed by ``consume``."""
    from randomprojection_tpu_torch.streaming import ArraySource

    serial = np.concatenate([y for _, y in est.transform_stream(
        ArraySource(X, batch))])
    out = []
    for lo, y in est.transform_stream(ingest(ArraySource(X, batch))):
        if consume is not None:
            consume(lo)
        out.append(y)
    return serial, np.concatenate(out)


@pytest.mark.parametrize("ingest", ["prefetch", "staged"])
def test_streamed_uploads_under_allocator_churn_equal_serial(cuda, ingest):
    """Many small batches uploaded on the copy stream from worker threads,
    a consumer that stalls between batches while the card's allocator
    recycles blocks (a churn tensor allocated and freed a batch): every
    batch equals the serial stream bit for bit.  Without the event wait
    and ``record_stream`` a block still read by the projection could be
    handed to the next upload."""
    import time

    from randomprojection_tpu_torch import SparseRandomProjection
    from randomprojection_tpu_torch.streaming import (
        PrefetchSource,
        StagedIngestSource,
    )

    X = np.random.default_rng(4).normal(size=(96 * 257, 1024)).astype(
        np.float32)
    est = SparseRandomProjection(256, density=1 / 3, random_state=1,
                                 backend_options={"materialization": "lazy"}
                                 ).fit(X)
    wrap = {
        "prefetch": lambda s: PrefetchSource(s, depth=4,
                                             prepare=est.prepare_batch),
        "staged": lambda s: StagedIngestSource(s, workers=4, depth=4,
                                               prepare=est.prepare_batch),
    }[ingest]

    def consume(lo):
        churn = torch.empty(257 * 1024, device=cuda)
        churn.fill_(float(lo))
        del churn
        if (lo // 257) % 7 == 3:
            time.sleep(0.01)

    serial, got = _serial_and(wrap, est, X, 257, consume)
    np.testing.assert_array_equal(got, serial)


def test_prepare_batch_from_a_worker_copies_on_a_side_stream(cuda):
    """A worker thread's ``prepare_batch`` queues its copy on the card's
    copy stream, not on the default stream: with the default stream held
    busy by a long kernel, the copy lands and reads back on the copy stream
    before that kernel ends, which a copy queued behind it could not do;
    the batch then projects as the direct transform does."""
    import threading

    from randomprojection_tpu_torch import GaussianRandomProjection
    from randomprojection_tpu_torch.ops.staging import StagedBatch, copy_stream

    X = np.random.default_rng(5).normal(size=(4096, 512)).astype(np.float32)
    est = GaussianRandomProjection(64, random_state=0).fit(X)
    default = torch.cuda.default_stream(cuda)
    side = copy_stream(cuda)
    assert side != default
    # warm the pinned host cache and the copy stream's device pool, so the
    # timed upload allocates nothing
    warm = est.prepare_batch(-X)
    torch.cuda.synchronize(cuda)
    del warm
    got = {}

    def worker():
        got["stream"] = torch.cuda.current_stream(cuda)
        got["batch"] = est.prepare_batch(X)

    with torch.cuda.stream(default):
        torch.cuda._sleep(int(2e9))  # about a second of the default stream
    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    assert got["stream"] == default
    b = got["batch"]
    assert isinstance(b, StagedBatch) and b.tensor.is_cuda
    b.event.synchronize()
    with torch.cuda.stream(side):
        back = b.tensor.cpu().numpy()
    assert not default.query(), "the upload waited for the default stream"
    np.testing.assert_array_equal(back, X)
    torch.cuda.synchronize(cuda)
    y = est._transform_async(b)
    np.testing.assert_array_equal(y.cpu().numpy(), est.transform(X))


def test_countsketch_staged_batches_match_serial(cuda):
    import scipy.sparse as sp

    from randomprojection_tpu_torch.models.sketch import CountSketch
    from randomprojection_tpu_torch.streaming import (
        ArraySource,
        StagedIngestSource,
    )

    rng = np.random.default_rng(26)
    X = rng.normal(size=(4096, 1 << 14)).astype(np.float32)
    X[np.abs(X) < 2.5] = 0.0
    Xs = sp.csr_array(X)
    cs = CountSketch(256, random_state=0).fit(Xs)
    serial = np.concatenate([y for _, y in cs.transform_stream(
        ArraySource(Xs, 512))])
    staged = np.concatenate([y for _, y in cs.transform_stream(
        StagedIngestSource(ArraySource(Xs, 512), workers=3,
                           prepare=cs.prepare_batch))])
    np.testing.assert_allclose(staged, serial, rtol=2e-5, atol=2e-5)


def test_bench_smoke_on_the_card(cuda):
    """``bench --preset smoke`` on the card ends with the compact line; the
    headline mode is believable and within the distortion budget."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    from randomprojection_tpu_torch import benchmark

    r = subprocess.run(
        [sys.executable, "-m", "randomprojection_tpu_torch", "bench",
         "--preset", "smoke"],
        cwd=Path(__file__).resolve().parents[1], capture_output=True,
        text=True, timeout=900,
    )
    assert r.returncode == 0, r.stderr[-4000:]
    lines = r.stdout.strip().splitlines()
    compact = benchmark.find_compact_line(lines[-1])
    assert compact is not None
    assert len(lines[-1].encode()) <= benchmark.COMPACT_MAX_BYTES
    record = json.loads(lines[-2])
    head = record["all_modes"][record["mode"]]
    assert compact["mode"] == record["mode"]
    assert head["timing_suspect"] is False and compact["timing_suspect"] is False
    assert head["distortion"] <= benchmark.DISTORTION_BUDGET
    assert record["device"] == torch.cuda.get_device_name(0)


def _run_scraped(argv, scrape):
    """``cli.main(argv)`` on a thread; while it runs, ``scrape(port)`` is
    called on this thread with the live endpoint's port until it returns
    True.  Returns the command's stdout lines and whether a scrape got
    through."""
    import contextlib
    import io
    import threading
    import time

    from randomprojection_tpu_torch import cli

    out, err = io.StringIO(), []

    def run():
        try:
            with contextlib.redirect_stdout(out):
                cli.main(list(argv))
        except BaseException as e:  # surfaced after the join
            err.append(e)

    t = threading.Thread(target=run, name="rp-torch-test-cli", daemon=True)
    t.start()
    done = False
    while t.is_alive() and not done:
        server = cli._METRICS_SERVER
        if server is not None:
            try:
                done = scrape(server.port)
            except OSError:
                pass
        time.sleep(0.05)
    t.join(timeout=300)
    assert not t.is_alive() and not err, err
    return out.getvalue().strip().splitlines(), done


def test_loadgen_with_the_live_plane_on_the_card(cuda):
    """A short open-loop run at 2^16 codes with the metrics endpoint and
    the health plane on: a mid-run scrape carries the ``sharded`` latency
    histogram, ``/health`` answers, and K4 launched one scan and one merge
    per coalesced batch (the warm-up's included), none on another route."""
    import json
    import urllib.error
    import urllib.request

    from randomprojection_tpu_torch.ops import topk_kernels as tk
    from randomprojection_tpu_torch.utils import telemetry
    from randomprojection_tpu_torch.utils.metrics_server import (
        fetch_metrics,
        parse_openmetrics,
    )

    seen = {}

    def scrape(port):
        plain, labeled = parse_openmetrics(fetch_metrics("127.0.0.1", port))
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/health", timeout=5) as r:
                seen["health"] = r.status
        except urllib.error.HTTPError as e:
            seen["health"] = e.code
        if "rp_serve_latency_sharded_seconds_bucket" in labeled:
            seen["labeled"] = labeled
            return True
        return False

    tk.reset_launches()
    lines, scraped = _run_scraped(
        ["loadgen", "--rate", "200", "--duration", "2", "--index-codes",
         str(1 << 16), "--code-bytes", "32", "--m", "16", "--metrics-port",
         "0", "--health", "25"], scrape)
    launches = dict(tk.LAUNCHES)
    rec = json.loads(lines[-1])
    assert scraped and seen["health"] in (200, 503)
    assert rec["errors"] == 0 and rec["rejects"] == 0
    batches = rec["server"]["batches"]
    assert 1 <= batches <= rec["requests"] + 1
    assert launches.get("rp_fused_topk_wgmma") == batches
    assert launches.get("rp_topk_merge") == batches
    assert not launches.get("rp_fused_topk_popc")
    assert not telemetry._SUBSCRIPTIONS


def test_topk_bench_on_the_card(cuda):
    """``topk-bench`` at 2^16 codes on the card: the wgmma route, both
    rates, and the tiered index's answers equal to the resident one's."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    r = subprocess.run(
        [sys.executable, "-m", "randomprojection_tpu_torch", "topk-bench",
         "--index-codes", str(1 << 16), "--queries", "2048",
         "--hbm-budget", str(1 << 20), "--probes", "2"],
        cwd=Path(__file__).resolve().parents[1], capture_output=True,
        text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-4000:]
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert rec["topk_impl"] == "wgmma"
    assert rec["direct_queries_per_s"] > 0 and rec["server_queries_per_s"] > 0
    assert rec["device"] == torch.cuda.get_device_name(0)
    assert rec["tiered"]["parity_ok"] and rec["tiered"]["fallbacks"] == 0
    assert rec["lsh"]["probe_path_resolved"] == "device"


# -- the sharded serving tier -------------------------------------------------


def _shard_corpus(n=1 << 16, nq=300, seed=21):
    g = np.random.default_rng(seed)
    return (g.integers(0, 256, size=(n, 32), dtype=np.uint8),
            g.integers(0, 256, size=(nq, 32), dtype=np.uint8))


def test_eight_shards_on_one_card_equal_the_one_device_index(cuda):
    """8 shards sharing the card answer as the one-device index does, bit
    for bit (ids int64), over tiles with a ragged last one, with 1%
    deleted across shard boundaries and with ids offset past int32."""
    from randomprojection_tpu_torch.models.sketch import SimHashIndex
    from randomprojection_tpu_torch.serving import ShardedSimHashIndex

    codes, q = _shard_corpus()
    one = SimHashIndex(codes, device=cuda)
    sh = ShardedSimHashIndex(codes, devices=[cuda], n_shards=8)
    assert sh.devices == [torch.device("cuda", 0)] * 8
    for m in (1, 16, 200):
        d, i = sh.query_topk(q, m, tile=128)
        wd, wi = one.query_topk(q, m, tile=128)
        assert i.dtype == np.int64
        assert np.array_equal(d, wd) and np.array_equal(i, wi)
    span = codes.shape[0] // 8
    dead = np.unique(np.concatenate([
        np.random.default_rng(3).choice(codes.shape[0], 655, replace=False),
        np.arange(span - 40, span + 40)]))
    assert sh.delete(dead) == one.delete(dead) == dead.size
    d, i = sh.query_topk(q, 16)
    wd, wi = one.query_topk(q, 16)
    assert np.array_equal(d, wd) and np.array_equal(i, wi)
    off = 2**31 + 13
    wide = ShardedSimHashIndex(codes, devices=[cuda], n_shards=8,
                               id_offset=off)
    d, i = wide.query_topk(q, 16)
    wd, wi = SimHashIndex(codes, device=cuda).query_topk(q, 16)
    assert np.array_equal(d, wd) and np.array_equal(i, wi.astype(np.int64) + off)


def test_sharded_query_launches_a_scan_and_a_merge_per_shard_a_tile(cuda):
    """K4's launches around one call: one wgmma scan and one merge a
    shard a query tile, none on the popc route; an empty shard launches
    nothing."""
    from randomprojection_tpu_torch.ops import topk_kernels as tk
    from randomprojection_tpu_torch.serving import ShardedSimHashIndex

    codes, q = _shard_corpus()
    sh = ShardedSimHashIndex(codes, devices=[cuda], n_shards=8)
    sh.query_topk(q, 16, tile=128)  # warm
    tk.reset_launches()
    sh.query_topk(q, 16, tile=128)
    torch.cuda.synchronize()
    tiles = -(-q.shape[0] // 128)
    assert tk.LAUNCHES == {"rp_fused_topk_wgmma": 8 * tiles,
                           "rp_fused_topk_popc": 0,
                           "rp_topk_merge": 8 * tiles}
    tiny = ShardedSimHashIndex(codes[:5], devices=[cuda], n_shards=8)
    tk.reset_launches()
    tiny.query_topk(q, 3)
    assert tk.LAUNCHES["rp_fused_topk_wgmma"] == 5


def test_sharded_lsh_device_rung_at_full_coverage_is_exact(cuda):
    """The sharded LSH tier on the device rung (K5, then K4 on each
    shard's candidates) at full probe coverage equals the exact answer bit
    for bit, with tombstones across shard boundaries; K5 launches twice a
    shard a tile, inside its graph."""
    from randomprojection_tpu_torch.ann import LSHShardedSimHashIndex
    from randomprojection_tpu_torch.models.sketch import SimHashIndex
    from randomprojection_tpu_torch.ops import probe_kernels as pk

    codes, q = _shard_corpus(n=1 << 14, nq=64)
    sh = LSHShardedSimHashIndex(codes, devices=[cuda], n_shards=8, bands=4,
                                band_bits=8, fallback_density=1.0)
    dead = np.arange(1900, 2300)  # across the first shard boundary
    sh.delete(dead)
    one = SimHashIndex(codes, device=cuda)
    one.delete(dead)
    want = one.query_topk(q, 10)
    sh.query_topk(q, 10, tile=64, probes=1 << 8)  # warm: captures
    pk.reset_launches()
    d, i = sh.query_topk(q, 10, tile=64, probes=1 << 8)
    assert np.array_equal(d, want[0])
    assert np.array_equal(i, want[1].astype(np.int64))
    assert pk.LAUNCHES["rp_probe"] == 2 * 8 and pk.GRAPH_REPLAYS == 8


# -- the projection half of the scale-out (PR 14) --------------------------------------


@pytest.mark.parametrize("mode", ["split2", "f32", "bf16"])
def test_fused_kernel_at_a_feature_shard_offset(cuda, mode):
    """K1 at config 3's feature-shard shape (d = 8,192 of 16,384 → 512,
    block offsets 0 and 16) on 1,024 rows: a column view of the batch read
    in place, within 1e-5·max|Y| of the plain version at the same offset."""
    x = _x(1024, 16384, seed=5)
    if mode == "bf16":
        x = x.to(torch.bfloat16)
    for j, offset in enumerate((0, 16)):
        view = x[:, j * 8192:(j + 1) * 8192]
        assert not view.is_contiguous()
        y = fk.rp_fused_project(view, 0, 512, 1 / 128, block_offset=offset,
                                mxu_mode=mode)
        torch.cuda.synchronize()
        want = fk.fused_project(view, 0, 512, 1 / 128, block_offset=offset,
                                mxu_mode=mode)
        err = (y - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item(), (offset, err)


@pytest.mark.parametrize("mode", ["split2", "bf16"])
@pytest.mark.parametrize("c0,c1", [(512, 1536), (0, 1100), (3, 1027),
                                   (1, 700)])
def test_strided_x_equals_a_contiguous_copy(cuda, mode, c0, c1):
    """A column slice read with the batch's row pitch (the TMA route where
    the base and pitch are 16-byte aligned, cp.async elsewhere, bf16 of odd
    alignment copied first) equals the kernel on a contiguous copy, bit
    for bit."""
    x = _x(257, 2048, seed=c0)
    if mode == "bf16":
        x = x.to(torch.bfloat16)
    view = x[:, c0:c1]
    got = fk.fused_sparse_project(view, 9, 64, 1 / 3, block_offset=1,
                                  mxu_mode=mode)
    want = fk.fused_sparse_project(view.contiguous(), 9, 64, 1 / 3,
                                   block_offset=1, mxu_mode=mode)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _card_mesh(cuda, shape):
    from randomprojection_tpu_torch.parallel import make_mesh

    return make_mesh(shape, devices=[cuda] * int(np.prod(list(shape.values()))))


def test_lazy_dp_mesh_is_bit_exact_on_the_card(cuda):
    """Lazy DP over 8 positions of the card: one K1 a row block, each
    writing its rows of one output, one mask cache shared by all; equal to
    one device bit for bit (K1's rows do not depend on their batch)."""
    from randomprojection_tpu_torch import SparseRandomProjection

    x = _x(4096, 2048, seed=6)
    opts = {"materialization": "lazy"}
    dp = SparseRandomProjection(64, random_state=2, backend_options={
        **opts, "mesh": _card_mesh(cuda, {"data": 8})}).fit(x)
    one = SparseRandomProjection(64, random_state=2,
                                 backend_options=opts).fit(x)
    want = one.transform(x)
    fk.reset_launches()
    got = dp.transform(x)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["rp_fused_project"] == 8
    assert fk.LAUNCHES["rp_mask_cache"] == 1
    assert torch.equal(got, want)


def test_lazy_dp_tp_mesh_within_tolerance_on_the_card(cuda):
    """Lazy DP×TP {data 4, feature 2} on the card: 8 K1 launches at block
    offsets 0 and 2, one mask cache a feature shard, the two partials of a
    row block added in order; within 1e-5·max|Y| of one device.  Dense and
    split2 TP too."""
    from randomprojection_tpu_torch import SparseRandomProjection

    x = _x(4096, 2048, seed=7)
    mesh = _card_mesh(cuda, {"data": 4, "feature": 2})
    for opts in ({"materialization": "lazy"}, {}, {"precision": "split2"}):
        tp = SparseRandomProjection(64, random_state=3, backend_options={
            **opts, "mesh": mesh, "feature_axis": "feature"}).fit(x)
        one = SparseRandomProjection(64, random_state=3,
                                     backend_options=opts).fit(x)
        fk.reset_launches()
        got = tp.transform(x)
        torch.cuda.synchronize()
        if opts.get("materialization") == "lazy":
            assert fk.LAUNCHES["rp_fused_project"] == 8
            assert fk.LAUNCHES["rp_mask_cache"] == 2
        else:
            assert fk.LAUNCHES["rp_fused_project"] == 0
        want = one.transform(x)
        err = (got - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item(), (opts, err)


def test_countsketch_mesh_on_the_card(cuda):
    """CountSketch over 8 positions of the card, dense and CSR, within
    rtol = atol = 2e-5 of one device."""
    import scipy.sparse as sp

    from randomprojection_tpu_torch import CountSketch

    rng = np.random.default_rng(8)
    X = rng.normal(size=(1001, 3000)).astype(np.float32)
    X[np.abs(X) < 1.5] = 0.0
    mesh = _card_mesh(cuda, {"data": 8})
    for data in (X, sp.csr_array(X)):
        m = CountSketch(64, random_state=0, mesh=mesh).fit(data)
        one = CountSketch(64, random_state=0).fit(data)
        np.testing.assert_allclose(m.transform(data), one.transform(data),
                                   rtol=2e-5, atol=2e-5)
