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


# -- the plan ------------------------------------------------------------------------


@pytest.mark.parametrize(
    "nq,rows,nb,m",
    [
        (2048, 1 << 24, 32, 16),   # the config-4 serving shape
        (128, 1 << 24, 32, 16),    # a small server batch: more splits
        (33, 257, 4, 33),
        (1, 128, 1 << 21, 120),    # 2^24-bit rows
        (8, 1 << 20, 32, tk.MAX_M),
        (5, 10, 3, 7),
    ],
)
def test_plan_serves_every_shape_the_reference_plans(nq, rows, nb, m):
    assert ref_tk.plan_fused(nq, rows, nb, m) is not None
    plan = tk.plan_fused(nq, rows, nb, m, sm_count=H100_SXM_SMS)
    assert plan is not None and plan.tq in (16, 32, 64)
    assert 1 <= plan.splits <= 32
    assert plan.splits * plan.tiles_per_split * 128 >= rows
    assert (plan.splits - 1) * plan.tiles_per_split * 128 < rows
    assert plan.smem_bytes == tk.smem_bytes(plan.tq, m) <= 232_448


def test_plan_bounds():
    sms = {"sm_count": H100_SXM_SMS}
    assert tk.plan_fused(8, 64, 32, tk.MAX_M + 1, **sms) is None
    assert tk.plan_fused(8, 64, (1 << 21) + 8, 4, **sms) is None  # > 2^24 bits
    assert ref_tk.plan_fused(8, 64, (1 << 21) + 8, 4) is None
    for bad in ((0, 64, 32, 4), (8, 0, 32, 4), (8, 64, 32, 0)):
        assert tk.plan_fused(*bad, **sms) is None


@pytest.mark.parametrize("sms", [H100_SXM_SMS, 114, 78])  # SXM, PCIe, a small part
def test_plan_aims_at_four_blocks_per_sm_of_the_card(sms):
    p = tk.plan_fused(2048, 1 << 24, 32, 16, sm_count=sms)
    blocks = -(-2048 // p.tq) * p.splits
    assert p.tq == 64 and 4 * sms <= blocks < 4 * sms + 2048 // p.tq


# -- the wrapper's device rule and checks --------------------------------------------


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    tk.reset_launches()
    A, B, _ = _case(100, 8, 5, 2)
    got = tk.fused_topk(torch.from_numpy(A), torch.from_numpy(B), 100, 4)
    want = tk.topk_plain(torch.from_numpy(A), torch.from_numpy(B), 100, 4)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert tk.LAUNCHES == {"rp_fused_topk": 0}


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
