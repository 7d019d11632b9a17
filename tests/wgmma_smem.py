"""The shared memory of K1's and K2's wgmma kernel for bf16 x bf16, int8 x
int8 and bf16 queries on int8 codes (asym), in Python: `wg::smem_at` and
`wg::smem_fit` of hbird_tpu_torch/ops/csrc/wgmma_topk.cuh, with their
constants read from that header and hopper.cuh.

Resident queries take one 8 KB chunk per 128 bytes of depth (64 rows);
asym adds four widened 16 KB tiles; each of the two consumers' rings needs
at least one stage (bf16 and int8: 16 KB of bank rows, asym: 8 KB of
codes), all under a block's SMEM_LIMIT: bf16 fits up to D = 1,536, int8
up to 3,072, asym up to 1,152. Past that the queries stream: a stage holds
the item's 8 KB query chunk beside the bank rows, nothing grows with
depth, and four stages a ring fit (197,888 bytes in every form; a streamed
form needs two).
`WgmmaLibrary(prefix)` answers `<prefix>_wgmma_smem(d, form)` for forms
1-3 as the compiled library does, so the CPU tests can hold
`knn_cuda.route` to the kernel's formula without nvcc; chip_smoke.py holds
the compiled library's own report to the same edges on the card.
"""

import pathlib
import re

CSRC = pathlib.Path(__file__).resolve().parents[1] / "hbird_tpu_torch" / "ops" / "csrc"
HEADER = (CSRC / "wgmma_topk.cuh").read_text()


def _const(name, text=HEADER):
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def _form(name, field):
    """A form's `static constexpr int` field, from its struct (or the one it
    derives from)."""
    body = re.search(rf"struct {name}\b(?: : (\w+))? \{{(.*?)\n\}};", HEADER, re.S)
    found = re.search(rf"\b{field} = (\d+)", body.group(2))
    return int(found.group(1)) if found else _form(body.group(1), field)


SMEM_LIMIT = _const("SMEM_LIMIT")
BAR_BYTES = _const("BAR_BYTES")
MAX_STAGES = _const("MAX_STAGES")
BQH = _const("BQH")
BMH = _const("BMH")
CHUNK_BYTES = _const("CHUNK_BYTES")
SMEM_ALIGN = _const("SMEM_ALIGN", (CSRC / "hopper.cuh").read_text())
Q_CHUNK = BQH * CHUNK_BYTES
WIDE_TILE = BMH * CHUNK_BYTES
BF16_FORM, S8_FORM, ASYM_FORM = 1, 2, 3
# form: (depth a chunk, bank bytes of a ring stage, the consumers' own tiles)
FORMS = {
    BF16_FORM: (_form("Bf16", "DK"), BMH * _form("Bf16", "B_BYTES"), 0),
    S8_FORM: (_form("S8", "DK"), BMH * _form("S8", "B_BYTES"), 0),
    ASYM_FORM: (_form("Asym", "DK"), BMH * _form("Asym", "B_BYTES"), 4 * WIDE_TILE),
}


def smem_at(form, d, streamed=False):
    """Dynamic shared memory of `form` at depth d with its queries resident
    or streamed; 0: it does not fit."""
    dk, codes, own = FORMS[form]
    fixed = SMEM_ALIGN + (0 if streamed else -(-d // dk) * Q_CHUNK) + own + BAR_BYTES
    stage = codes + (Q_CHUNK if streamed else 0)
    fit = (SMEM_LIMIT - fixed) // (2 * stage)
    stages = MAX_STAGES if fit >= MAX_STAGES else (fit if fit >= (2 if streamed else 1) else 0)
    return fixed + 2 * stages * stage if stages else 0


def smem(form, d):
    """What the library reports: the resident form's size where it fits,
    else the streamed one's."""
    return smem_at(form, d) or smem_at(form, d, streamed=True)


class WgmmaLibrary:
    """A stand-in for K1's or K2's compiled library in `knn_cuda.route`: its
    `<prefix>_wgmma_smem(d, form)` reports `smem(form, d)` for bf16, int8 x
    int8 and asym, and a fit for f32 (always streamed)."""

    def __init__(self, prefix):
        setattr(self, f"{prefix}_wgmma_smem", lambda d, form: smem(form, d) if form in FORMS else 1)
