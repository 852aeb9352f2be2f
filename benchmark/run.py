"""Runs one benchmark cell of the PyTorch / CUDA port once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the checkout's root. Prints the result as the last line of standard
output and each compared number beside its limit as the last lines of
standard error. Exits non-zero, printing no result, without enough CUDA
cards for the cell, or when JAX or the JAX package got loaded.
"""
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
CACHE = os.path.join(ROOT, ".bench_cache")
# the program's kernel caches, at fixed paths inside the checkout
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["USE_FLAX"] = "0"
# one intra-op thread: the cells' host work is the launch loop, which more
# threads only contend with
os.environ["OMP_NUM_THREADS"] = "1"
sys.path[:0] = [BENCH_DIR, ROOT]

from harness.cells import load_cell, process_start  # noqa: E402


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    t_start = process_start()
    cell = load_cell(args.workload, ROOT)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has {have}",
              file=sys.stderr)
        return 3
    from harness.runner import emit, execute

    line, lines = execute(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), t_start)
    emit(line, lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
