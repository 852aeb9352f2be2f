"""Nothing the benchmark loads is JAX or the JAX package."""
import glob
import os
import subprocess
import sys

from harness.cells import BENCH_DIR, FORBIDDEN, ROOT

LOAD_ALL = r"""
import glob, json, os, sys
sys.path[:0] = [{bench!r}, {root!r}]
from harness import cells, compare, flops, readers, runner, trace, traffic, weights
import importlib
for package in ("reference", "programs"):
    for path in glob.glob(os.path.join({bench!r}, package, "*.py")):
        importlib.import_module(package + "." + os.path.basename(path)[:-3])
spec = json.load(open(os.path.join({root!r}, "BENCHMARK.json")))
for w in spec["workloads"]:
    cell = cells.load_cell(w["name"], {root!r})
    cells.load_entry(cell)
for path in glob.glob(os.path.join({bench!r}, "metrics", "*.py")):
    cells._module(path, "m_" + os.path.basename(path).replace(".", "_"))
import run, control
print("forbidden=" + ",".join(cells.forbidden_modules()))
"""


def test_no_jax_loaded():
    code = LOAD_ALL.format(bench=BENCH_DIR, root=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "forbidden="


def test_forbidden_names_compare_whole_top_level():
    from harness.cells import forbidden_modules

    assert forbidden_modules(["fastvision_tpu_torch", "fastvision_tpu_torch.train",
                              "jaxtyping", "flax_like", "numpy"]) == []
    assert forbidden_modules(["jaxlib.xla_client", "fastvision_tpu.ops", "optax",
                              "orbax.checkpoint", "flax.linen", "jax"]) == sorted(FORBIDDEN)


def test_no_source_imports_jax():
    names = "|".join(FORBIDDEN)
    import re

    pat = re.compile(rf"^\s*(import|from)\s+({names})(\s|\.|$)", re.M)
    for path in glob.glob(os.path.join(BENCH_DIR, "**", "*.py"), recursive=True):
        with open(path) as f:
            assert not pat.search(f.read()), path
