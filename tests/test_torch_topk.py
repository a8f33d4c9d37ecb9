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
    # the grid covers every row, and no split is empty
    assert 1 <= plan.splits <= 32
    assert plan.splits * plan.tiles_per_split * plan.tile_rows >= rows
    assert (plan.splits - 1) * plan.tiles_per_split * plan.tile_rows < rows
    assert plan.smem_bytes == tk.smem_bytes(plan.route, plan.tq, m,
                                            plan.stages, nb) <= 232_448


@pytest.mark.parametrize("nq,rows,nb,m", SHAPES)
def test_route_is_chosen_from_the_shape_alone(nq, rows, nb, m):
    """The tensor-core route wherever its lists fit beside a ring of two
    stages, whatever the width or alignment; else the popc route."""
    plan = tk.plan_fused(nq, rows, nb, m, sm_count=H100_SXM_SMS)
    fits = tk.smem_bytes("wgmma", 64, m, 2, nb) <= 232_448
    assert plan.route == ("wgmma" if fits else "popc")
    assert fits == (m <= (378 if nb <= 32 else 370))
    if fits and nq > 64 and tk.smem_bytes("wgmma", 128, m, 4, nb) <= 232_448:
        assert plan.tq == 128  # two warpgroups share each code tile
    popc = tk._plan_popc(nq, rows, m, H100_SXM_SMS)
    assert popc.route == "popc" and popc.smem_bytes <= 232_448


@pytest.mark.parametrize("nb,m,route", [(32, 378, "wgmma"), (32, 379, "popc"),
                                        (3, 378, "wgmma"), (36, 370, "wgmma"),
                                        (36, 371, "popc"), (1 << 16, 370, "wgmma"),
                                        (32, tk.MAX_M, "popc")])
def test_route_limit_is_the_lists_room_in_shared_memory(nb, m, route):
    assert tk.plan_fused(8, 1 << 20, nb, m, sm_count=H100_SXM_SMS).route == route


@pytest.mark.parametrize("m,tq,stages", [(16, 128, 8), (89, 128, 8),
                                         (90, 128, 7), (153, 128, 4),
                                         (154, 64, 8), (300, 64, 4),
                                         (378, 64, 2)])
def test_wgmma_plan_takes_the_deepest_ring_that_fits(m, tq, stages):
    plan = tk.plan_fused(2048, 1 << 20, 32, m, sm_count=H100_SXM_SMS)
    assert (plan.route, plan.tq, plan.stages) == ("wgmma", tq, stages)
    if stages < 8:
        assert tk.smem_bytes("wgmma", tq, m, stages + 1) > 232_448


def test_wgmma_smem_formula():
    # alignment slack, barriers and 8 stages' liveness bits; stages x (c, ~c);
    # q slots x (q, ~q); the lists
    assert tk.smem_bytes("wgmma", 128, 16, 8) == \
        1024 + 128 + 8 * 64 + 8 * 2 * 256 * 32 + 2 * 128 * 32 + 128 * 16 * 8
    # rows wider than a k-step ring their query steps too
    assert tk.smem_bytes("wgmma", 64, 10, 3, 36) == \
        1024 + 128 + 8 * 64 + 3 * 2 * 256 * 32 + 3 * 2 * 64 * 32 + 64 * 10 * 8
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


@pytest.mark.parametrize("sms", [H100_SXM_SMS, 114, 78])
@pytest.mark.parametrize("nq", [2048, 4096, 640, 64])
def test_wgmma_plan_fills_one_wave_of_the_card(sms, nq):
    """One block an SM: the splits leave the fewest tile steps on the
    longest-running SM, and no choice of splits does better."""
    rows = 1 << 24
    p = tk.plan_fused(nq, rows, 32, 16, sm_count=sms)
    q_tiles, n_tiles = -(-nq // p.tq), -(-rows // 256)

    def steps(s):
        return -(-q_tiles * s // sms) * -(-n_tiles // s)

    assert steps(p.splits) == min(steps(s) for s in range(1, 33))
    if q_tiles * 32 >= sms:
        assert q_tiles * p.splits >= sms // 2  # at least half the card busy


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
