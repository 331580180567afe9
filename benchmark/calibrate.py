"""Readings the check's limits are set from: for each seed, the numbers the
cell compares for the program and, on the control seeds, for the control
(the reference one precision step below the configuration's, put in the
program's place), in one process.

    python benchmark/calibrate.py --workload <name> --seeds 1,2,3 --control-seeds 1,2,3

One JSON line a seed on standard output."""

import argparse
import importlib
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    args = parser.parse_args(argv)
    from benchmark import harness

    harness.fix_cache_dirs(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("[calibrate] needs a CUDA device", file=sys.stderr)
        return 2
    spec = harness.load_cell(ROOT, args.workload)
    driver = importlib.import_module(f"benchmark.drivers.{spec.traffic['driver']}")
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        with tempfile.TemporaryDirectory(prefix="calib-") as tmp:
            ctx = harness.Ctx(spec=spec, seed=seed, device=torch.device("cuda"), tmp=tmp)
            out = driver.calibrate(ctx, seed in controls)
        print(json.dumps({"seed": seed, **out}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
