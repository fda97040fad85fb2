"""The benchmark of rufus_tpu_torch on CUDA cards: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's configuration, traffic mix and metrics are found by name from
BENCHMARK.json (``lib/registry.py``); ``lib/harness.py`` runs set-up, the
window of jobs and the comparison. With --trace 0 the result line holds the
cell's end-to-end metrics; with --trace 1 the window runs under
torch.profiler and the line holds its per-layer metrics. The last line of
stdout is the result; the compared numbers and their limits are the last
lines of stderr.

Without a CUDA card, or with fewer than the cell asks for, it exits 2 and
prints no result; ``rehearse.py`` is the only way to run a cell on the
CPU. It exits 3 if a module of JAX or of the JAX package is loaded once
the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if CHECKOUT not in sys.path:
    sys.path.insert(0, CHECKOUT)

# every build and kernel cache of a run inside the checkout, at fixed paths;
# the program builds its own kernels into build/rufus_tpu_torch/
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = os.path.join(CHECKOUT, "build", "cache", _sub)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from benchmark.lib import harness
    from benchmark.lib.registry import Registry

    cell = Registry().cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card and does not "
              "fall back to the CPU (benchmark/rehearse.py runs a cell there)",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = harness.measure(cell, args.seed, args.seconds, bool(args.trace),
                             "cuda", T_START)
    banned = harness.banned_modules()
    if banned:
        print(f"modules of JAX or the JAX package were loaded: {banned}",
              file=sys.stderr)
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
