"""What a run reads by name, and what it prints.

A cell is an entry of ``workloads`` in ``BENCHMARK.json`` at the
checkout's root: its configuration's file (``configs``), its traffic mix
``benchmark/traffic/<traffic>.json`` (whose ``entry`` names the driver
``benchmark/entries/<entry>.py``), its model's plain reference
``benchmark/reference/<model>.py`` and the port's builder
``benchmark/programs/<model>.py``, its limits
``benchmark/limits/<cell>.json``, and the metrics that name it. A
per-layer metric is read by ``benchmark/metrics/<metric>.py``; a kernel
group (``conv``, ``nms``) is the union of ``benchmark/kernels/<group>/*.json``.
Adding any of these is adding a file.
"""
from __future__ import annotations

import glob
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "fastvision_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    root: str = ROOT

    @property
    def bench_dir(self) -> str:
        return os.path.join(self.root, "benchmark")


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> Cell:
    spec = _load(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    bench = os.path.join(root, "benchmark")
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in reported else [])]
    return Cell(name=name, chips=int(w["chips"]),
                config=_load(os.path.join(root, conf["file"])),
                traffic=_load(os.path.join(bench, "traffic", f"{w['traffic']}.json")),
                limits=_load(os.path.join(bench, "limits", f"{name}.json")),
                end_to_end=e2e, per_layer=per_layer, root=root)


def load_entry(cell: Cell):
    return _module(os.path.join(cell.bench_dir, "entries", f"{cell.traffic['entry']}.py"),
                   f"bench_entry_{cell.traffic['entry']}")


def by_model(package: str, cfg: dict):
    """The module ``benchmark/<package>/<cfg['model']>.py`` ('reference':
    the plain model and loss; 'programs': how the port's are built)."""
    name = f"{package}.{cfg['model']}"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise ValueError(f"no benchmark/{package}/{cfg['model']}.py for the model "
                         f"{cfg['model']!r}") from e


def read_metric(cell: Cell, metric: dict, run) -> float | None:
    """The reader ``benchmark/metrics/<name>.py``'s ``read(run)``; None
    when it finds nothing to read."""
    mod = _module(os.path.join(cell.bench_dir, "metrics", f"{metric['name']}.py"),
                  "bench_metric_" + metric["name"].replace(".", "_").replace("-", "_"))
    return mod.read(run)


def kernel_group(cell: Cell, group: str) -> dict:
    """{'ops': host ranges, 'kernels': name patterns} of every file of
    ``benchmark/kernels/<group>/``."""
    out = {"ops": [], "kernels": []}
    for path in sorted(glob.glob(os.path.join(cell.bench_dir, "kernels", group, "*.json"))):
        spec = _load(path)
        out["ops"] += spec.get("ops", [])
        out["kernels"] += spec.get("kernels", [])
    return out


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names among ``modules`` (default: ``sys.modules``) that
    are JAX or the JAX package, compared whole (``fastvision_tpu_torch``
    is not ``fastvision_tpu``)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules if modules is None else modules)}
    return sorted(tops & set(FORBIDDEN))


def process_start() -> float:
    """The process's start on ``time.time()``'s clock (Linux), or now."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def finite(obj):
    """``obj`` with every non-finite float replaced by None (strict JSON)."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite(v) for v in obj]
    return obj


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                check: dict, breakdown: dict | None = None) -> str:
    """The last line of standard output: the contract's keys, ``check``
    (each compared number beside its limit, null where it is not finite)
    last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["check"] = check
    return json.dumps(finite(out), allow_nan=False)
