"""The readings that the limits of `correct` are set from; the benchmark's
own runs never run this.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 \
        [--fault NAME] [--device cuda|cpu] [--genome-bp n]

Without --fault, the control: the plain reference put in the program's
place with one guarantee that the configuration states broken, k-mers
told apart by a 32-bit fingerprint instead of their exact key
(``reference/kmers.py:fingerprint``), at the cell's own size. Its outputs
go through the same comparison as a job's. With --fault NAME, one run of
the cell (its warm-up job and one timed job) with that fault of
``faults.py`` planted under the program. Prints one JSON line a seed: the
compared numbers and, for a fault, `correct`.
"""

import argparse
import contextlib
import json
import os
import sys
import time

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if CHECKOUT not in sys.path:
    sys.path.insert(0, CHECKOUT)


def control_numbers(cell: dict, seed: int, device: str,
                    genome_bp: int | None = None) -> dict:
    """The control's compared numbers on the trio of `seed`."""
    from benchmark.lib import harness
    from benchmark.reference import compare, kmers

    trio = harness.make_trio(cell, seed, device, genome_bp)
    rufus, rt = cell["config"]["rufus"], harness.route(cell)
    exp = compare.Expected(trio, rufus, rt, device)
    ctl = compare.Expected(trio, rufus, rt, device, ident=kmers.fingerprint)
    return compare.numbers(ctl.outputs, exp,
                           cell["config"]["input"] == "fastq")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--genome-bp", type=int, default=None)
    args = p.parse_args(argv)
    from benchmark import faults
    from benchmark.lib import harness
    from benchmark.lib.registry import Registry

    cell = Registry().cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.fault is None:
            line = {"control": "fingerprint32", "numbers": control_numbers(
                cell, seed, args.device, args.genome_bp)}
        else:
            plant = faults.FAULTS[args.fault]()
            with plant, contextlib.redirect_stdout(sys.stderr):
                r = harness.measure(cell, seed, 1e-3, False, args.device,
                                    time.perf_counter(), args.genome_bp)
            line = {"fault": args.fault, "correct": r["correct"],
                    "numbers": {n: c["value"] for n, c in r["checks"].items()}}
        print(json.dumps({"workload": args.workload, "seed": seed, **line,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
