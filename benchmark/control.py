"""Readings that set a cell's limits, several seeds in one process.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --what program,fp8,half_batch

- ``program``: a whole run of the cell (a short window) per seed: the
  program's readings against the reference, the lower end of each limit;
- ``program32``: the same with the program in float32, TF32 off: a
  witness that a gap comes from the configuration's bfloat16 alone;
- ``fp8``: the control, the reference under bfloat16 autocast with its
  GEMMs in fp8 (`reference.layers`), put in the program's place, against
  the float32 reference;
- ``half_batch``: the fault that trains on half of each batch, planted in
  the reference, against the float32 reference.

One JSON line per seed and kind on standard output. The benchmark's own
runs never run the control or the fault.
"""
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".bench_cache", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, ".bench_cache", "torch_extensions")
sys.path[:0] = [BENCH_DIR, ROOT]

from harness.cells import load_cell  # noqa: E402


def reference_readings(cell, seed: int, kinds: list[str], device) -> list[dict]:
    import torch

    from harness.compare import train_readings
    from harness.traffic import train_pool
    from harness.weights import make_weights
    from reference import build
    from reference.train import reference_steps

    cfg, n = cell.config, cell.traffic["compare_steps"]
    with torch.device("meta"):
        shapes = build(cfg)
    pool = train_pool(cfg, cell.traffic, seed, device)[:n]
    ref = reference_steps(cfg, make_weights(shapes, seed, device), pool, device)
    out = []
    for kind in kinds:
        other = reference_steps(cfg, make_weights(shapes, seed, device), pool, device,
                                fp8=kind == "fp8", half_batch=kind == "half_batch")
        out.append({"kind": kind, "seed": seed, **train_readings(other, ref)})
    return out


def program_readings(cell, seed: int, seconds: float, device, fp32: bool) -> dict:
    import copy

    import torch

    from harness.cells import load_entry

    if fp32:
        cell = copy.deepcopy(cell)
        cell.config["dtype"] = "float32"
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    if fp32:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        res = load_entry(cell).run(cell, seed, seconds, False, device, time.time())
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    return {"kind": "program32" if fp32 else "program", "seed": seed, **res["readings"],
            "train_img_s": res["end_to_end"]["train_img_s"]}


def main() -> int:
    import argparse

    import torch

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--what", default="program,fp8,half_batch")
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args()
    cell = load_cell(args.workload, ROOT)
    device = torch.device("cuda", 0)
    kinds = args.what.split(",")
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.time()
        for kind in ("program", "program32"):
            if kind in kinds:
                print(json.dumps(program_readings(cell, seed, args.seconds, device,
                                                  kind == "program32")), flush=True)
        rest = [k for k in kinds if not k.startswith("program")]
        if rest:
            for r in reference_readings(cell, seed, rest, device):
                print(json.dumps(r), flush=True)
        print(f"seed {seed}: {time.time() - t:.1f} s", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
