"""Readings that set the limits of ``correct``: the program's compared
numbers over many seeds, the control's (the reference put in the program's
place with TF32 on) and planted faults', each at the cell's own size.

    python3 h100_bench/calibrate.py --workload <cell> --seeds 1 2 3 --kind program
    python3 h100_bench/calibrate.py --workload <cell> --seeds 1 2 3 --kind tf32

``program`` runs the cell's set-up and one window call per seed and then
its check; any other kind runs the set-up and the entry's ``control``
(``tf32``; ``half_batch`` and ``altered`` for the training cells). One line
of JSON per seed. The benchmark's runs do not run this.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import argparse  # noqa: E402

from h100_bench.core import harness, precision, registry  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--kind", default="program")
    args = p.parse_args(argv)
    import torch
    from geometric_adv_tpu_torch.ops.cuda.build import load_library

    load_library()
    for seed in args.seeds:
        cell = harness.cell_from_files(args.workload, seed)
        cell.device = torch.device("cuda:0")
        precision.apply(precision.stated(cell.config["tf32"]))
        entry = registry.module("entries", cell.workload["entry"])
        t0 = time.perf_counter()
        state = entry.setup(cell)
        if args.kind == "program":
            entry.call(state)
            checks = entry.check(state)
        else:
            checks = entry.control(state, args.kind)
        del state
        torch.cuda.empty_cache()
        info = {k: v for k, v in cell.info.items() if k != "chips"}
        print(json.dumps({"cell": args.workload, "kind": args.kind, "seed": seed,
                          "seconds": time.perf_counter() - t0,
                          "checks": {c.name: c.value for c in checks}, "info": info},
                         default=str), flush=True)


if __name__ == "__main__":
    main()
