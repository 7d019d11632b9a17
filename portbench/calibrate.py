"""Readings that the limits of `limits/<cell>.json` are set from.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--fault <name> --fault-seeds 4,5,6] [--seconds 3]

In one process, for each seed: the cell's set-up and a short window at the
cell's own load (at least the batches or the job whose outputs a run
judges), then the numbers of `portbench/check.py` for the program and, on
the control seeds, for the control (the reference in float8 in the
program's place). Then the fault seeds, with `portbench/faults.py`'s fault
planted under the timed path. One JSON line per seed; nothing is timed
here.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

from portbench.run import T0, execute, load_cell


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)

    import torch

    from portbench.harness import Ctx

    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    spec = load_cell(args.workload)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    dev = torch.device("cuda", 0)
    runs = [(int(s), "") for s in args.seeds.split(",") if s]
    runs += [(int(s), args.fault) for s in args.fault_seeds.split(",") if s]
    planted = False
    for seed, fault in runs:
        if fault and not planted:
            from portbench.faults import FAULTS

            FAULTS[fault][0](setattr)  # planted for the fault seeds, which come last
            planted = True
        torch.cuda.reset_peak_memory_stats()
        ctx = Ctx(args.workload, spec["config"], spec["traffic"], seed, args.seconds, False, dev, T0)
        out = execute(ctx, [], spec["limits"], with_control=seed in controls)
        res = out["res"]
        print(json.dumps({"seed": seed, "fault": fault, "numbers": out["numbers"], "control": out["control"],
                          "correct": out["correct"], "setup_s": res["setup_s"],
                          "window_s": res["window_s"], "peak_gib": res["peak_bytes"] / 2**30}), flush=True)
        del out, res
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
