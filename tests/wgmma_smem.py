"""The shared memory of K1's and K2's wgmma kernel for int8 x int8, in
Python: `wg::smem_at<wg::S8>` of hbird_tpu_torch/ops/csrc/wgmma_topk.cuh,
with its constants read from that header and hopper.cuh.

The 64 resident query rows take one 8 KB chunk per 128 bytes of depth, and
each of the two consumers' rings needs at least one 16 KB stage, all under
a block's SMEM_LIMIT: D = 3072 fits (one stage a ring), D = 3088 does not.
`S8Library(prefix)` answers `<prefix>_wgmma_smem(d, form)` for form 2 as the
compiled library does, so the CPU tests can hold `knn_cuda.route` to the
kernel's limit without nvcc; chip_smoke.py holds the compiled library's own
report to the same edge on the card.
"""

import pathlib
import re

CSRC = pathlib.Path(__file__).resolve().parents[1] / "hbird_tpu_torch" / "ops" / "csrc"


def _const(header, name):
    text = (CSRC / header).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


SMEM_LIMIT = _const("wgmma_topk.cuh", "SMEM_LIMIT")
BAR_BYTES = _const("wgmma_topk.cuh", "BAR_BYTES")
MAX_STAGES = _const("wgmma_topk.cuh", "MAX_STAGES")
BQH = _const("wgmma_topk.cuh", "BQH")
BMH = _const("wgmma_topk.cuh", "BMH")
CHUNK_BYTES = _const("wgmma_topk.cuh", "CHUNK_BYTES")
SMEM_ALIGN = _const("hopper.cuh", "SMEM_ALIGN")
S8_FORM = 2


def s8_smem(d):
    """Dynamic shared memory of the S8 kernel at depth d; 0: it does not fit."""
    n_chunks = -(-d // CHUNK_BYTES)  # S8's chunk: 128 int8 columns
    fixed = SMEM_ALIGN + n_chunks * BQH * CHUNK_BYTES + BAR_BYTES
    stage = BMH * CHUNK_BYTES
    stages = min(MAX_STAGES, max(0, (SMEM_LIMIT - fixed) // (2 * stage)))
    return fixed + 2 * stages * stage if stages else 0


class S8Library:
    """A stand-in for K1's or K2's compiled library in `knn_cuda.route`: its
    `<prefix>_wgmma_smem(d, form)` reports `s8_smem(d)` for int8 x int8 and
    a fit for every other form."""

    def __init__(self, prefix):
        setattr(self, f"{prefix}_wgmma_smem", lambda d, form: s8_smem(d) if form == S8_FORM else 1)
