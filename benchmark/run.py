"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell names a configuration
(``configs/<file>.json``) and a traffic mix (``traffic/<traffic>.json``);
the mix names its driver (``drivers/<driver>.py``), which builds the
program from the seed, warms up every shape it will time, measures for
``--seconds`` and checks what the timed path produced against the plain
reference. With ``--trace 1`` the window runs under ``torch.profiler`` and
each per-layer metric of the cell is read by ``layer_metrics/<name>.py``.
The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown``,
``checks``); the numbers compared, each beside its limit, are also the last
lines of standard error. Exits non-zero without a result where there is no
CUDA device, too few of them, or a module of JAX or of the JAX package was
loaded."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from benchmark import harness

    harness.fix_cache_dirs(ROOT)
    spec = harness.load_cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        print(f"[bench] needs {spec.chips} CUDA device(s); torch.cuda.is_available() "
              f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    driver = importlib.import_module(f"benchmark.drivers.{spec.traffic['driver']}")
    result = harness.run_cell(spec, driver, args.seed, args.seconds, bool(args.trace),
                              T_START, torch.device("cuda"))
    found = harness.forbidden_modules()
    if found:
        print(f"[bench] forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
