"""A cell's run on the CPU, at a tiny slice, through the program's plain
PyTorch versions: the rehearsal of ``run.py`` where there is no card.

    python3 benchmark/rehearse.py --workload <cell> [--seed n]
        [--seconds s] [--trace 0|1] [--genome-bp n]

Its result line has the device "cpu" and no device metric. The benchmark's
measurement (``run.py``) never runs on the CPU.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if CHECKOUT not in sys.path:
    sys.path.insert(0, CHECKOUT)

GENOME_BP = 20_000  # a tiny slice: seconds a job on a CPU


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--genome-bp", type=int, default=GENOME_BP)
    args = p.parse_args(argv)
    from benchmark.lib import harness
    from benchmark.lib.registry import Registry

    cell = Registry().cell(args.workload)
    result = harness.measure(cell, args.seed, args.seconds, bool(args.trace),
                             "cpu", T_START, genome_bp=args.genome_bp)
    harness.emit(result)
    return 0 if result["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
