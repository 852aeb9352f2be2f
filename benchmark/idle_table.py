"""Where a training cell's card sits idle, by the program's own spans.

    python3 benchmark/idle_table.py --workload <cell> --seed <n> --seconds <s>

from the checkout's root, on a CUDA card. Runs the cell once with its
traced slices, as ``benchmark/run.py --trace 1`` does, and prints: the
window's ``train_img_s`` beside the rate `Fit` logged for that epoch
(``epoch_img_s``), the cell's per-layer metrics, and the host-and-card
slice's idle milliseconds a step by the innermost program span the
host's main thread was in (`harness.spans.idle_by_span`), each with its
top host operations. The rows add up to the slice's idle time. The last
line of standard output repeats it all as JSON.
"""
import json
import sys

import run  # noqa: F401  (the benchmark's environment and import paths)
from harness.cells import load_cell, load_entry, process_start, read_metric
from harness.spans import idle_by_span

TOP_OPS = 3  # host operations shown a row


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    t_start = process_start()
    cell = load_cell(args.workload, run.ROOT)

    import torch

    if not torch.cuda.is_available():
        print(f"{args.workload} needs a CUDA card", file=sys.stderr)
        return 3
    entry = load_entry(cell)
    epochs = []

    class Keep(entry.Capture):
        def log(self, step, **metrics):
            super().log(step, **metrics)
            if "epoch_img_s" in metrics:
                epochs.append(metrics["epoch_img_s"])

    entry.Capture = Keep
    out = entry.run(cell, args.seed, args.seconds, True, torch.device("cuda", 0), t_start)
    info, traffic = out["run"], cell.traffic
    # epochs: the compared steps (one each), the warm-up, the window, the traced slices
    window_epoch = epochs[traffic["compare_steps"] + 1]
    rate = out["end_to_end"]["train_img_s"]
    metrics = {m["name"]: read_metric(cell, m, info) for m in cell.per_layer}
    t, steps = info.trace, info.trace_steps
    rows = idle_by_span(t)
    idle_ms = (t.window_s - t.busy_s) * 1e3
    print(f"{cell.name} seed {args.seed} on {info.device_name}")
    print(f"train_img_s {rate!r}, the window epoch's epoch_img_s {window_epoch!r} "
          f"(ratio {window_epoch / rate!r})")
    for name, value in metrics.items():
        print(f"{name}: {value!r}")
    print(f"\nhost-and-card slice: {steps} steps, idle {idle_ms / steps!r} ms a step "
          f"of {t.window_s * 1e3 / steps!r}\n")
    print("| Innermost span | Idle ms a step | Share | Top host operations (ms a step) |")
    print("|---|---|---|---|")
    table = {}
    for name, r in sorted(rows.items(), key=lambda kv: -kv[1]["us"]):
        ops = sorted(r["ops"].items(), key=lambda kv: -kv[1])
        table[name] = {"ms": r["us"] / 1e3 / steps,
                       "ops": {k: v / 1e3 / steps for k, v in ops[:TOP_OPS]}}
        shown = ", ".join(f"`{k}` {v:.3f}" for k, v in table[name]["ops"].items())
        print(f"| `{name}` | {table[name]['ms']:.3f} | {100 * r['us'] / 1e3 / idle_ms:.1f}% "
              f"| {shown} |")
    print(f"| sum | {sum(v['ms'] for v in table.values()):.3f} | | |")
    print(json.dumps({"cell": cell.name, "seed": args.seed, "device": info.device_name,
                      "train_img_s": rate, "window_epoch_img_s": window_epoch,
                      "metrics": metrics, "trace_steps": steps,
                      "idle_ms_a_step": idle_ms / steps, "rows": table,
                      "memory_peak_bytes": out["memory_peak_bytes"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
