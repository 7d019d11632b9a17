"""The control and the faults, on the CPU at a tiny size.

The control is the reference computed in float8 e4m3 in the program's
place (portbench/check.py::Judge.control): each of the numbers it passes
through (the forward, the memory rows, the search) has to read far above
the program's. The faults drive the rest of a run through the harness, with
the timed path broken underneath, and `correct` has to come out false under
each cell's own limits:

- a memory step that leaves the bank as it was (rows never written);
- half of each eval batch left out of the confusion counts;
- an answer altered where it is produced: the search's neighbours shifted
  by one row, or the predicted map shifted by one class after the counts;
- the flash attention kernel returning zeros (on the LayerScale
  configuration too, whose blocks the features have to show);
- a tree that deals its rows to leaves at random, or keeps its initial
  centroids.

The plants are portbench/faults.py's.

The cells run on one chip, so no exchange between chips can be left out.
The readings of the control at the cells' own sizes are in PERF.md.
"""

from __future__ import annotations

import json

import pytest

from portbench.faults import FAULTS
from portbench.run import ROOT
from portbench.test_portbench_harness import tiny_run

CELL_OF = {"eval": "dinov2_vitb14.eval.flat-10m", "job": "mae_vith14.job.ivf"}


def cell_limits(kind):
    return json.loads((ROOT / "portbench" / "limits" / f"{CELL_OF[kind]}.json").read_text())


@pytest.mark.parametrize("kind", ["eval", "job"])
def test_control_reads_far_above_the_program_and_is_not_correct(kind):
    from portbench.check import verdict

    _, out, _ = tiny_run(kind, with_control=True)
    prog, ctrl = out["numbers"], out["control"]
    for name in ("feat", "bank", "knn"):
        assert ctrl[name] >= 3 * prog[name], (name, prog[name], ctrl[name])
    assert ctrl["pred"] > prog["pred"] == 0.0
    # The control's exact numbers are its own consistency: they read 0.
    assert not verdict(dict(prog, **ctrl), cell_limits(kind))


@pytest.mark.parametrize("kind", ["eval", "job"])
def test_unbroken_run_is_correct_under_the_cells_limits(kind):
    from portbench.check import verdict

    _, out, _ = tiny_run(kind)
    assert verdict(out["numbers"], cell_limits(kind)), out["numbers"]


@pytest.mark.parametrize("kind,fault", [(k, f) for f in sorted(FAULTS) for k in FAULTS[f][2]])
def test_fault_makes_the_run_incorrect(kind, fault, monkeypatch):
    from portbench.check import verdict

    plant, caught_by, _ = FAULTS[fault]
    plant(monkeypatch.setattr)
    _, out, _ = tiny_run(kind)
    limits = cell_limits(kind)
    assert out["numbers"][caught_by] > limits[caught_by], out["numbers"]
    assert not verdict(out["numbers"], limits)
