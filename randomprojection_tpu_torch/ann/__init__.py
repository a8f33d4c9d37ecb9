"""Multi-probe LSH candidate tier (the port of ``randomprojection_tpu/ann``):
banded CSR bucket indexes over packed SimHash codes, multi-probe candidate
generation (the probe count is the recall/q-s knob), an exact re-rank of
only the candidates with the top-k kernel, a fallback ladder that never
serves worse than the exact path, and snapshots (``load_lsh_index``).  See
``lsh.py``."""

from randomprojection_tpu_torch.ann.lsh import (
    BandedBuckets,
    BandPlan,
    LSHSimHashIndex,
    band_keys,
    load_lsh_index,
    probe_masks,
)

__all__ = [
    "BandPlan",
    "band_keys",
    "probe_masks",
    "BandedBuckets",
    "LSHSimHashIndex",
    "load_lsh_index",
]
