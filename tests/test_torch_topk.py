"""The port's Hamming top-k (plain version) against the JAX package's fused
Pallas kernel run in interpret mode, bit for bit in distance and id.

The reference's ``fused_topk(..., interpret=True)`` takes a few seconds a
call here, so the cases are few and small; explicit reference plans make
them cross several kernel blocks (byte tiles, packed queries, a clamped
ragged last block).  The CUDA kernel itself is held to the plain version
on the card (tests/test_torch_cuda.py and chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from randomprojection_tpu.models import sketch as ref_sketch
from randomprojection_tpu.ops import topk_kernels as ref_tk
from randomprojection_tpu_torch.ops import topk_kernels as tk

H100_SXM_SMS = 132


def _case(rows, nb, nq, seed, *, dup=False, n_dead=0, low_bits=None):
    rng = np.random.default_rng(seed)
    B = rng.integers(0, 256, size=(rows, nb), dtype=np.uint8)
    A = rng.integers(0, 256, size=(nq, nb), dtype=np.uint8)
    if dup:  # duplicated rows: ties broken by the lower id
        B[rows // 2: rows // 2 + 30] = B[3]
        B[-40:] = B[3]
        A[:4] = B[3]
    if low_bits is not None:  # a ragged width: pad bits zero on both sides
        B[:, -1] &= (1 << low_bits) - 1
        A[:, -1] &= (1 << low_bits) - 1
    dead = None
    if n_dead:
        dead = np.zeros(rows, np.uint8)
        dead[rng.choice(rows, n_dead, replace=False)] = 1
    return A, B, dead


# (rows, bytes, queries, real rows, m, tombstones, duplicates, pad-bit
# mask, reference plan)
CASES = [
    (1000, 32, 24, 990, 40, 100, True, None,
     ref_tk.TopkPlan(8, 128, 8, True, 64)),
    (1000, 32, 24, 990, 40, 100, True, None,
     ref_tk.TopkPlan(16, 64, 32, False, 64)),
    (257, 4, 33, 257, 33, 0, False, None, None),   # m > 32
    (300, 3, 20, 290, 12, 7, False, 4, None),      # 20 bits in 3 bytes
]


@pytest.mark.parametrize("rows,nb,nq,n_real,m,n_dead,dup,low,plan", CASES)
def test_plain_topk_equals_reference_kernel(rows, nb, nq, n_real, m, n_dead,
                                            dup, low, plan):
    A, B, dead = _case(rows, nb, nq, rows + nb + m, dup=dup, n_dead=n_dead,
                       low_bits=low)
    rd, ri = ref_tk.fused_topk(A, B, n_real, m, dead=dead, plan=plan,
                               interpret=True)
    d, i = tk.fused_topk(torch.from_numpy(A), torch.from_numpy(B), n_real, m,
                         dead=None if dead is None else torch.from_numpy(dead))
    assert d.dtype == i.dtype == torch.int32 and d.shape == (nq, m)
    np.testing.assert_array_equal(d.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))


def test_empty_slots_are_the_sentinel_pair():
    A, B, dead = _case(50, 8, 6, 1, n_dead=45)
    d, i = tk.topk_plain(torch.from_numpy(A), torch.from_numpy(B), 48, 10,
                         dead=torch.from_numpy(dead))
    # 50 rows, 48 real, 45 deleted: at most 5 live rows, the rest empty
    live = int(((dead == 0) & (np.arange(50) < 48)).sum())
    assert (d[:, live:] == 8 * 8 + 1).all()
    assert (i[:, live:] == 2**31 - 1).all()
    assert (d[:, :live] <= 64).all()


@pytest.mark.parametrize("n1,n2,nb", [(7, 300, 32), (40, 9, 3), (1, 1, 1)])
def test_hamming_counts_equals_reference_host(n1, n2, nb):
    rng = np.random.default_rng(n1 * n2)
    A = rng.integers(0, 256, size=(n1, nb), dtype=np.uint8)
    B = rng.integers(0, 256, size=(n2, nb), dtype=np.uint8)
    got = tk.hamming_counts(torch.from_numpy(A), torch.from_numpy(B))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  ref_sketch.pairwise_hamming(A, B))


@pytest.mark.parametrize(
    "n1,n2,nb,low",
    [(7, 300, 32, None), (40, 9, 3, 4), (1, 1, 1, None), (5, 70, 36, None),
     (9, 33, 250, 3), (3, 5, 64, None)],
)
def test_and_popc_identity_equals_hamming(n1, n2, nb, low):
    """The tensor-core route's product, popc(a & ~b) + popc(~a & b) over
    zero-padded 32-byte steps, is the Hamming distance: against the plain
    version's xor counts and the reference's host distances, tolerance 0."""
    A, B, _ = _case(n2, nb, n1, n1 + n2 + nb, low_bits=low)
    got = tk.and_popc_distances(torch.from_numpy(A), torch.from_numpy(B))
    assert got.dtype == torch.int32 and got.shape == (n1, n2)
    assert torch.equal(got, tk.hamming_counts(torch.from_numpy(A),
                                              torch.from_numpy(B)))
    np.testing.assert_array_equal(got.numpy(),
                                  ref_sketch.pairwise_hamming(A, B))


# -- the plan ------------------------------------------------------------------------

SHAPES = [
    (2048, 1 << 24, 32, 16),   # the config-4 serving shape
    (4096, 1 << 24, 32, 16),   # a coalesced server batch
    (128, 1 << 24, 32, 16),    # a small server batch: more splits
    (64, 1 << 19, 32, 10),     # an LSH tile's candidate rows
    (33, 257, 4, 33),
    (1, 128, 1 << 21, 120),    # 2^24-bit rows
    (8, 1 << 20, 32, tk.MAX_M),
    (5, 10, 3, 7),
    (300, 5000, 36, 256),
]


@pytest.mark.parametrize("nq,rows,nb,m", SHAPES)
def test_plan_serves_every_shape_the_reference_plans(nq, rows, nb, m):
    assert ref_tk.plan_fused(nq, rows, nb, m) is not None
    plan = tk.plan_fused(nq, rows, nb, m, sm_count=H100_SXM_SMS)
    assert plan is not None and plan.route in ("wgmma", "popc")
    if plan.route == "wgmma":
        assert plan.tq in (64, 128) and plan.tile_rows == 256
        assert 2 <= plan.stages <= 8
    else:
        assert plan.tq in (16, 32, 64) and plan.tile_rows == 128
        assert plan.stages == 0
    # the grid covers every row, no split is empty, and the split lists
    # fit the scratch bound and a launch's grid
    assert 1 <= plan.splits <= tk._MAX_SPLITS
    assert nq * plan.splits * m * 8 <= max(tk._SCRATCH_BYTES, nq * m * 8)
    assert plan.splits * plan.tiles_per_split * plan.tile_rows >= rows
    assert (plan.splits - 1) * plan.tiles_per_split * plan.tile_rows < rows
    assert plan.smem_bytes == tk.smem_bytes(plan.route, plan.tq, m,
                                            plan.stages, nb,
                                            plan.buf) <= 232_448


@pytest.mark.parametrize("nq,rows,nb,m", SHAPES)
def test_route_is_chosen_from_the_shape_alone(nq, rows, nb, m):
    """The tensor-core route wherever its lists and the least buffers fit
    beside a ring of two stages, whatever the width or alignment; else the
    popc route."""
    plan = tk.plan_fused(nq, rows, nb, m, sm_count=H100_SXM_SMS)
    fits = tk.smem_bytes("wgmma", 64, m, 2, nb) <= 232_448
    assert plan.route == ("wgmma" if fits else "popc")
    assert fits == (m <= (369 if nb <= 32 else 361))
    if fits and nq > 64 and tk.smem_bytes("wgmma", 128, m, 4, nb) <= 232_448:
        assert plan.tq == 128  # two warpgroups share each code tile
    popc = tk._plan_popc(nq, rows, m, H100_SXM_SMS)
    assert popc.route == "popc" and popc.smem_bytes <= 232_448


@pytest.mark.parametrize("nb,m,route", [(32, 369, "wgmma"), (32, 370, "popc"),
                                        (3, 369, "wgmma"), (36, 361, "wgmma"),
                                        (36, 362, "popc"), (1 << 16, 361, "wgmma"),
                                        (32, tk.MAX_M, "popc")])
def test_route_limit_is_the_lists_room_in_shared_memory(nb, m, route):
    assert tk.plan_fused(8, 1 << 20, nb, m, sm_count=H100_SXM_SMS).route == route


@pytest.mark.parametrize("m,tq,stages", [(16, 128, 8), (80, 128, 8),
                                         (81, 128, 7), (144, 128, 4),
                                         (145, 64, 8), (300, 64, 4),
                                         (369, 64, 2)])
def test_wgmma_plan_takes_the_deepest_ring_that_fits(m, tq, stages):
    plan = tk.plan_fused(2048, 1 << 20, 32, m, sm_count=H100_SXM_SMS)
    assert (plan.route, plan.tq, plan.stages) == ("wgmma", tq, stages)
    if stages < 8:
        assert tk.smem_bytes("wgmma", tq, m, stages + 1) > 232_448


def test_wgmma_plan_fits_lists_and_buffers_for_every_m_it_takes():
    """Every m the tensor-core route takes: the planned buffer is one the
    kernel takes (32 keys for m up to a warp's lanes), and the lists, the
    buffers and the ring fit the block's shared memory; the ring is the
    deepest the least buffers allow."""
    top = max(m for m in range(1, tk.MAX_M + 1)
              if tk.smem_bytes("wgmma", 64, m, 2, 32) <= 232_448)
    for m in range(1, top + 1):
        for nq in (64, 2048):
            p = tk.plan_fused(nq, 1 << 20, 32, m, sm_count=H100_SXM_SMS)
            assert p.route == "wgmma" and p.buf in (8, 16, 32)
            assert p.smem_bytes == tk.smem_bytes(
                "wgmma", p.tq, m, p.stages, 32, p.buf) <= 232_448
            assert m > 32 or p.buf == 32
            assert p.stages == 8 or tk.smem_bytes(
                "wgmma", p.tq, m, p.stages + 1, 32) > 232_448
            bigger = [b for b in (16, 32) if b > p.buf]
            assert all(tk.smem_bytes("wgmma", p.tq, m, p.stages, 32, b)
                       > 232_448 for b in bigger)
    assert tk.plan_fused(64, 1 << 20, 32, top + 1,
                         sm_count=H100_SXM_SMS).route == "popc"


# the config-4 cells' shapes: the bulk cell's tile over 1B, the open loop's
# batches (one query up to the server's largest) over one card's 125M
# shard, an LSH tile's re-rank over its 2^20 slots
@pytest.mark.parametrize("nq,rows,m", [(2048, 10**9, 16), (1, 125_000_000, 16),
                                       (48, 125_000_000, 16),
                                       (8192, 125_000_000, 16),
                                       (64, 1 << 20, 10)])
def test_config4_shapes_keep_a_ring_of_eight_stages(nq, rows, m):
    p = tk.plan_fused(nq, rows, 32, m, sm_count=H100_SXM_SMS)
    assert (p.route, p.stages, p.buf) == ("wgmma", 8, 32)


def _survivor_case(nq, rows, m, corpus, n_dead, seed):
    rng = np.random.default_rng(seed)
    B = rng.integers(0, 256, size=(rows, 32), dtype=np.uint8)
    A = rng.integers(0, 256, size=(nq, 32), dtype=np.uint8)
    if corpus == "equal":
        B[:] = B[0]
    elif corpus == "descending":  # every row nearer than all before it
        ones = 256 - (np.arange(rows) * 256) // rows
        B = np.packbits((np.arange(256)[None, :] < ones[:, None])
                        .astype(np.uint8), axis=1, bitorder="little")
        A[:] = 0
    dead = None
    if n_dead:
        dead = np.zeros(rows, np.uint8)
        dead[rng.choice(rows, n_dead, replace=False)] = 1
        dead = torch.from_numpy(dead)
    return torch.from_numpy(A), torch.from_numpy(B), dead


# (queries, rows, real rows, m, corpus, tombstones, forced splits)
SURVIVOR_CASES = [
    (20, 3000, 3000, 16, "random", 0, None),
    (20, 3000, 3000, 1, "equal", 0, 3),        # every distance equal
    (21, 3000, 3000, 10, "descending", 0, 2),  # every row survives
    (17, 4000, 3900, 33, "random", 50, 5),     # m past a warp's lanes
    (37, 5000, 4990, 40, "equal", 100, 3),
    (40, 2600, 2571, 32, "last", 30, 4),       # neighbours in last tiles
    (3, 2000, 2000, 369, "random", 0, None),   # the route's largest m
]


@pytest.mark.parametrize("nq,rows,n_real,m,corpus,n_dead,splits",
                         SURVIVOR_CASES)
def test_buffered_selection_keeps_the_plain_top_m(nq, rows, n_real, m, corpus,
                                                  n_dead, splits):
    """The tensor-core scan's survivors' path, step for step on the host
    (``mma_scan_plain``: stale thresholds between merges, ties at the
    threshold, merges before an overflow and at a split's end), merged
    over its splits, is the plain top-m bit for bit."""
    q, codes, dead = _survivor_case(nq, rows, m, corpus, n_dead, rows + m)
    plan = tk.plan_fused(nq, rows, 32, m, sm_count=H100_SXM_SMS)
    n_tiles = -(-rows // 256)
    if splits:
        tps = -(-n_tiles // splits)
        plan = plan._replace(splits=-(-n_tiles // tps), tiles_per_split=tps)
    if corpus == "last":  # each split's last tile holds near copies
        for s in range(plan.splits):
            t = min((s + 1) * plan.tiles_per_split, n_tiles) - 1
            codes[t * 256: t * 256 + nq] = q ^ (1 << (s % 8))
    part, keys, merges = tk.mma_scan_plain(q, codes, n_real, m, plan,
                                           dead=dead)
    assert part.shape == (nq, plan.splits, m)
    assert (np.diff(part, axis=2) >= 0).all()  # each split list ascending
    key = np.sort(part.reshape(nq, -1), axis=1)[:, :m]
    gone = (key >> 32) > 256
    wd, wi = tk.topk_plain(q, codes, n_real, m, dead=dead)
    np.testing.assert_array_equal(np.where(gone, 257, key >> 32), wd.numpy())
    np.testing.assert_array_equal(np.where(gone, 2**31 - 1, key & 0xFFFFFFFF),
                                  wi.numpy())
    # every list took its m keys at least once, and a merge a list at least
    assert keys >= nq * min(m, rows // plan.splits) and merges >= nq


def test_wgmma_smem_formula():
    # alignment slack, barriers and 8 stages' liveness bits; stages x (c, ~c);
    # q slots x (q, ~q); the lists; the buffers and a key of padding a row
    assert tk.smem_bytes("wgmma", 128, 16, 8, 32, 32) == \
        1024 + 128 + 8 * 64 + 8 * 2 * 256 * 32 + 2 * 128 * 32 + 128 * 16 * 8 \
        + 128 * 33 * 8
    # rows wider than a k-step ring their query steps too; the least buffer
    # by default
    assert tk.smem_bytes("wgmma", 64, 10, 3, 36) == \
        1024 + 128 + 8 * 64 + 3 * 2 * 256 * 32 + 3 * 2 * 64 * 32 + 64 * 10 * 8 \
        + 64 * 9 * 8
    assert tk.smem_bytes("popc", 64, 16) == \
        64 * 16 * 8 + (64 + 128) * 33 * 4 + 64 * 128 * 4


def test_plan_bounds():
    sms = {"sm_count": H100_SXM_SMS}
    assert tk.plan_fused(8, 64, 32, tk.MAX_M + 1, **sms) is None
    assert tk.plan_fused(8, 64, (1 << 21) + 8, 4, **sms) is None  # > 2^24 bits
    assert ref_tk.plan_fused(8, 64, (1 << 21) + 8, 4) is None
    for bad in ((0, 64, 32, 4), (8, 0, 32, 4), (8, 64, 32, 0)):
        assert tk.plan_fused(*bad, **sms) is None


@pytest.mark.parametrize("sms", [H100_SXM_SMS, 114, 78])  # SXM, PCIe, a small part
def test_plan_aims_at_four_blocks_per_sm_of_the_card(sms):
    # the popc route still aims at four blocks an SM
    p = tk._plan_popc(2048, 1 << 24, 16, sms)
    blocks = -(-2048 // p.tq) * p.splits
    assert p.tq == 64 and 4 * sms <= blocks < 4 * sms + 2048 // p.tq


def _most_splits(nq, n_tiles, m):
    """The splits a plan may take: the row tiles, the scratch bound and a
    launch's grid."""
    return min(tk._MAX_SPLITS, n_tiles, max(1, tk._SCRATCH_BYTES // (nq * m * 8)))


@pytest.mark.parametrize("sms", [H100_SXM_SMS, 114, 78])
@pytest.mark.parametrize("nq", [2048, 4096, 640, 64])
def test_wgmma_plan_fills_one_wave_of_the_card(sms, nq):
    """One block an SM: the splits leave the fewest tile steps on the
    longest-running SM, each split's warm-up counted, and no count the
    bounds allow does better; a full wave where the row tiles allow."""
    rows = 1 << 24
    p = tk.plan_fused(nq, rows, 32, 16, sm_count=sms)
    q_tiles, n_tiles = -(-nq // p.tq), -(-rows // 256)

    def steps(s):
        return (-(-q_tiles * s // sms)
                * (-(-n_tiles // s) + tk.SPLIT_WARMUP_TILES))

    assert steps(p.splits) == tk.wave_steps(q_tiles, n_tiles, p.splits, sms)
    assert steps(p.splits) == min(
        steps(s) for s in range(1, _most_splits(nq, n_tiles, 16) + 1))
    if q_tiles < sms:
        assert q_tiles * p.splits > sms - q_tiles  # a full wave, to a tile


# the 32-split cap's plan, as the planner had it before the merge took
# any number of lists: the fewest tile steps on the longest SM, no warm-up
def _capped_splits(q_tiles, n_tiles, sms):
    return min(range(1, min(32, n_tiles) + 1),
               key=lambda s: (-(-q_tiles * s // sms) * -(-n_tiles // s), s))


# (queries, codes, m): the open loop's batches over one card's 125M shard,
# the bulk cell's tile over 1B, and an LSH tile's candidate rows
@pytest.mark.parametrize("sms", [H100_SXM_SMS, 114, 78])
@pytest.mark.parametrize("nq,rows,m", [(1, 125_000_000, 16),
                                       (32, 125_000_000, 16),
                                       (48, 125_000_000, 16),
                                       (64, 125_000_000, 16),
                                       (128, 125_000_000, 16),
                                       (2048, 10**9, 16),
                                       (64, 1 << 19, 10)])
def test_wgmma_plan_at_the_callers_shapes(sms, nq, rows, m):
    p = tk.plan_fused(nq, rows, 32, m, sm_count=sms)
    assert p.route == "wgmma"
    q_tiles, n_tiles = -(-nq // p.tq), -(-rows // 256)
    assert p.splits * p.tiles_per_split >= n_tiles
    assert (p.splits - 1) * p.tiles_per_split < n_tiles
    assert nq * p.splits * m * 8 <= tk._SCRATCH_BYTES
    most = _most_splits(nq, n_tiles, m)
    best = min(tk.wave_steps(q_tiles, n_tiles, s, sms)
               for s in range(1, most + 1))
    assert tk.wave_steps(q_tiles, n_tiles, p.splits, sms) == best
    if rows == 125_000_000:  # one query tile: every SM, one wave
        assert q_tiles * p.splits >= sms
        assert q_tiles * p.splits == sms == p.splits
    if (nq, rows) == (2048, 10**9):
        # no more tile steps on the longest SM than the 32-cap plan's
        capped = _capped_splits(q_tiles, n_tiles, sms)
        assert tk.wave_steps(q_tiles, n_tiles, p.splits, sms) <= \
            tk.wave_steps(q_tiles, n_tiles, capped, sms)
    if (nq, rows) == (64, 1 << 19):
        # no more splits than the optimum: the least count at the best
        assert p.splits == min(s for s in range(1, most + 1)
                               if tk.wave_steps(q_tiles, n_tiles, s, sms) == best)


# (queries, codes, m) -> (route, tq, splits, tiles a split, stages, buf):
# the bulk cell's tile over 1B, an open-loop batch over one card's 125M
# shard, an LSH tile's re-rank over its 2^20 slots (the dead mask changes
# no plan), and the serving shape over 2^24
PLANS_AT_THE_CALLERS = [
    ((2048, 10**9, 16), ("wgmma", 128, 33, 118_372, 8, 32)),
    ((48, 125_000_000, 16), ("wgmma", 64, 132, 3_700, 8, 32)),
    ((64, 1 << 20, 10), ("wgmma", 64, 128, 32, 8, 32)),
    ((2048, 1 << 24, 16), ("wgmma", 128, 8, 8_192, 8, 32)),
]


@pytest.mark.parametrize("shape,want", PLANS_AT_THE_CALLERS)
def test_plans_at_the_callers_under_the_fitted_warmup(shape, want):
    """The plans the callers run under the re-fitted split warm-up, and
    the same for any W over the span both fits lie in (1,550 with the
    survivors' buffers, 1,850 with one insert a survivor)."""
    nq, rows, m = shape
    assert tk.SPLIT_WARMUP_TILES == 1550
    for w in (tk.SPLIT_WARMUP_TILES, 83, 1850, 4931):
        saved = tk.SPLIT_WARMUP_TILES
        try:
            tk.SPLIT_WARMUP_TILES = w
            p = tk._plan_wgmma(nq, rows, 32, m, H100_SXM_SMS)
        finally:
            tk.SPLIT_WARMUP_TILES = saved
        assert (p.route, p.tq, p.splits, p.tiles_per_split, p.stages,
                p.buf) == want, w


@pytest.mark.parametrize("nq,rows,m", [(1, 1 << 20, 16), (130, 528 * 256, 16),
                                       (2048, 1 << 24, 16), (7, 100, 3),
                                       (3, 1 << 22, 1024)])
def test_wave_slots_count_whole_waves_of_one_block_an_sm(nq, rows, m):
    """The counter's arithmetic, a pure function of a plan and the SMs."""
    for sms in (H100_SXM_SMS, 114, 78):
        p = tk.plan_fused(nq, rows, 32, m, sm_count=sms)
        blocks, slots = tk.wave_slots(p, nq, sms)
        assert blocks == -(-nq // p.tq) * p.splits
        assert slots % sms == 0 and blocks <= slots < blocks + sms
    p = tk.plan_fused(48, 125_000_000, 32, 16, sm_count=H100_SXM_SMS)
    assert tk.wave_slots(p, 48, H100_SXM_SMS) == (132, 132)
    assert tk.wave_slots(p._replace(splits=32), 48, H100_SXM_SMS) == (32, 132)
    assert tk.wave_slots(p._replace(splits=264), 48, H100_SXM_SMS) == (264, 264)


def test_plan_is_a_function_of_the_shape_kept_once():
    args = (48, 125_000_000, 32, 16)
    assert tk.plan_fused(*args, sm_count=132) is tk.plan_fused(*args,
                                                               sm_count=132)
    assert tk.plan_fused(*args, sm_count=114).splits == 114


# -- the wrapper's device rule and checks --------------------------------------------


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    tk.reset_launches()
    A, B, _ = _case(100, 8, 5, 2)
    got = tk.fused_topk(torch.from_numpy(A), torch.from_numpy(B), 100, 4)
    want = tk.topk_plain(torch.from_numpy(A), torch.from_numpy(B), 100, 4)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert not any(tk.LAUNCHES.values())


def test_kernel_launcher_refuses_cpu_and_other_devices():
    q = torch.zeros((2, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        tk.rp_fused_topk(q, torch.zeros((10, 8), dtype=torch.uint8), 10, 3)
    meta = torch.empty((2, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no top-k kernel"):
        tk.fused_topk(meta, meta, 2, 1)


@pytest.mark.parametrize(
    "q,codes,n_real,m,dead,match",
    [
        ((2, 8), (10, 4), 10, 3, None, "bytes a row"),
        ((2, 8), (10, 8), 11, 3, None, "n_real"),
        ((2, 8), (10, 8), 10, 0, None, "m must be positive"),
        ((2, 8), (10, 8), 10, 3, (9,), "dead"),
    ],
)
def test_argument_checks(q, codes, n_real, m, dead, match):
    u8 = dict(dtype=torch.uint8)
    with pytest.raises(ValueError, match=match):
        tk.fused_topk(torch.zeros(q, **u8), torch.zeros(codes, **u8), n_real,
                      m, dead=None if dead is None else torch.zeros(dead, **u8))
    with pytest.raises(ValueError, match="uint8"):
        tk.topk_plain(torch.zeros((2, 8)), torch.zeros((10, 8), **u8), 10, 3)


# -- the candidate lists' host merge ---------------------------------------------------


def _lexsort_merge(d_parts, i_parts, m, dedup, n_bits):
    """``merge_topm``'s contract row by row: the union's pairs (a repeated
    pair's later copies made empty under ``dedup``), the empty pair
    filling a narrow union, ``np.lexsort`` by (distance, id), the first
    ``m``."""
    d = np.concatenate(d_parts, axis=1).astype(np.int64)
    ids = np.concatenate(i_parts, axis=1).astype(np.int64)
    out_d = np.empty((d.shape[0], m), np.int64)
    out_i = np.empty((d.shape[0], m), np.int64)
    for r in range(d.shape[0]):
        dr, ir = d[r], ids[r]
        if dedup:
            _, first = np.unique(np.stack([dr, ir]), axis=1, return_index=True)
            keep = np.zeros(dr.size, bool)
            keep[first] = True
            dr = np.where(keep, dr, tk.empty_dist(n_bits))
            ir = np.where(keep, ir, tk.EMPTY_ID)
        if dr.size < m:
            dr = np.concatenate([dr, np.full(m - dr.size, tk.empty_dist(n_bits))])
            ir = np.concatenate([ir, np.full(m - ir.size, tk.EMPTY_ID)])
        o = np.lexsort((ir, dr))[:m]
        out_d[r], out_i[r] = dr[o], ir[o]
    return out_d, out_i


def _lists(rng, widths, ids, n_bits, *, empties=0, rows=12):
    """One candidate list a width, as the kernel writes them: each row's
    pairs drawn from ``ids`` (distinct within a list; a pair's distance is
    a function of its id, heavy in ties), in (distance, lower id) order,
    the last ``empties`` slots of every row the empty pair."""
    dist_of = {int(g): int(g) * 7 % 5 for g in np.unique(ids)}
    d_parts, i_parts = [], []
    for w in widths:
        d = np.empty((rows, w), np.int32)
        g = np.empty((rows, w), ids.dtype)
        for r in range(rows):
            pick = rng.choice(ids, size=w, replace=False)
            pd = np.array([dist_of[int(x)] for x in pick])
            o = np.lexsort((pick, pd))
            d[r], g[r] = pd[o], pick[o]
        if empties:
            d[:, w - empties:] = tk.empty_dist(n_bits)
            g[:, w - empties:] = tk.EMPTY_ID
        d_parts.append(d)
        i_parts.append(g)
    return d_parts, i_parts


@pytest.mark.parametrize("case", [
    "one_plane", "two_planes", "three_planes", "sixteen_planes",
    "empties_everywhere", "small_index", "ids_past_2_32",
    "dedup_repeated_ids", "dedup_disjoint", "narrow_union",
])
def test_merge_topm_equals_a_lexsort(case):
    rng = np.random.default_rng(sum(map(ord, case)))
    n_bits, m, dedup = 256, 9, False
    pool = np.arange(10_000, 10_400, dtype=np.int32)
    empties, widths = 0, (9, 5)
    if case == "one_plane":
        widths = (12,)
    elif case == "three_planes":
        widths = (3, 9, 6)
    elif case == "sixteen_planes":
        widths = tuple(1 + k % 9 for k in range(16))
    elif case == "empties_everywhere":
        widths, empties = (9, 6, 4), 3
    elif case == "small_index":
        # ids below 2^6: a key shifted by the ids' own 6 bits would let the
        # empty id 2^31-1 bleed into the distance bits
        pool, n_bits = np.arange(40, dtype=np.int32), 16
        widths, empties = (9, 7), 4
    elif case == "ids_past_2_32":
        pool = (1 << 32) + np.arange(0, 1 << 34, 1 << 25, dtype=np.int64)
    elif case == "dedup_repeated_ids":
        pool, dedup, empties = pool[:14], True, 2
    elif case == "dedup_disjoint":
        dedup = True
    elif case == "narrow_union":
        widths = (3, 2)
    if case in ("dedup_repeated_ids", "dedup_disjoint", "two_planes"):
        widths = (9, 9)
    if case == "dedup_disjoint":
        d0, i0 = _lists(rng, widths[:1], pool[:200], n_bits)
        d1, i1 = _lists(rng, widths[1:], pool[200:], n_bits)
        d_parts, i_parts = d0 + d1, i0 + i1
    else:
        d_parts, i_parts = _lists(rng, widths, pool, n_bits, empties=empties)
    if case == "dedup_repeated_ids":
        # the lists share ids, with their one distance each
        shared = [np.intersect1d(i_parts[0][r], i_parts[1][r])
                  for r in range(i_parts[0].shape[0])]
        assert any((s != tk.EMPTY_ID).any() for s in shared)
    got = tk.merge_topm(d_parts, i_parts, m, dedup=dedup, n_bits=n_bits)
    want = _lexsort_merge(d_parts, i_parts, m, dedup, n_bits)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == np.int32
    assert got[1].dtype == np.result_type(*i_parts)
    if case == "one_plane":
        # one list passes through as its first m columns
        assert np.shares_memory(got[0], d_parts[0])
        np.testing.assert_array_equal(got[1], i_parts[0][:, :m])
    if case == "dedup_disjoint":
        # nothing repeats, so dedup changes nothing
        plain = tk.merge_topm(d_parts, i_parts, m)
        np.testing.assert_array_equal(plain[0], got[0])
        np.testing.assert_array_equal(plain[1], got[1])
    if case == "narrow_union":
        assert (got[1][:, sum(widths):] == tk.EMPTY_ID).all()
        with pytest.raises(ValueError, match="n_bits"):
            tk.merge_topm(d_parts, i_parts, m)
