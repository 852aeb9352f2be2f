"""``compile_cache`` for the port's native builds (`core.mesh.
enable_compile_cache`, `cuda_build.set_build_dir`) on the CPU, where the
host libraries (``csrc/*.cpp``: the JPEG decoder, the letterbox, the MPEG-4
packer) build with the host compiler.

Two fresh processes run ``cli.main(["doctor", "compile_cache=<tmp>"])``
(here it builds the host libraries, prints its report and exits for want
of a card) and then load ``csrc/letterbox.cpp``:

  - the first builds every host library into ``<tmp>`` (``Build.seconds``
    > 0, the path under ``<tmp>``); doctor prints the value;
  - the second finds them all there: ``seconds == 0.0``, the same paths,
    and doctor lists them as found in the cache;
  - in the second, another directory raises once a library is loaded, the
    same one does not; loader workers started by ``forkserver`` (which do
    not inherit the parent's module state) load from ``<tmp>`` too.

In this process: `set_build_dir` refuses a second directory after a build,
and the default directory is ``_build/`` beside the package.
"""
import json
import os
import subprocess
import sys

import pytest

from fastvision_tpu_torch import cuda_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST = [n for n in cuda_build.sources() if cuda_build.kind(n) == "host"]

WORK = '''
import numpy as np


def work(item):
    """A loader worker's job: load the letterbox library, say from where."""
    from fastvision_tpu_torch import cuda_build
    from fastvision_tpu_torch.data.codec import letterbox_library

    letterbox_library()
    return np.zeros(1, np.uint8), {"build_dir": cuda_build.build_dir(),
                                   "letterbox": cuda_build._BUILDS["letterbox"].path}
'''

CHILD = '''
import json, sys
from fastvision_tpu_torch import cli, cuda_build
from fastvision_tpu_torch.core import enable_compile_cache
from fastvision_tpu_torch.data.codec import letterbox_library

cache, other, pool = sys.argv[1], sys.argv[2], sys.argv[3] == "1"
try:
    cli.main(["doctor", f"compile_cache={cache}"])
except SystemExit as e:
    doctor_exit = str(e)
letterbox_library()
out = {"doctor_exit": doctor_exit, "build_dir": cuda_build.build_dir(),
       "builds": {n: [b.seconds, b.path] for n, b in cuda_build._BUILDS.items()}}
try:
    enable_compile_cache(other)
except RuntimeError as e:
    out["mixing"] = str(e)
out["same_again"] = enable_compile_cache(cache)
if pool:
    from cachework import work
    from fastvision_tpu_torch.data.decode_pool import DecodePool

    p = DecodePool(work, 2, (1,), start_method="forkserver")
    out["workers"] = [aux for _, aux in p.imap(range(4))]
    p.close()
print("RESULT " + json.dumps(out))
'''


def _child(cache, other, pool: bool, workdir) -> tuple[dict, str]:
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([REPO, str(workdir)])}
    p = subprocess.run([sys.executable, "-c", CHILD, str(cache), str(other), str(int(pool))],
                       capture_output=True, text=True, env=env, cwd=str(workdir), timeout=300)
    assert p.returncode == 0, p.stderr[-4000:]
    line = next(ln for ln in p.stdout.splitlines() if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):]), p.stdout


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("compile_cache")
    (root / "cachework.py").write_text(WORK)
    cache, other = root / "cache", root / "other"
    first = _child(cache, other, False, root)
    second = _child(cache, other, True, root)
    return {"cache": str(cache), "other": str(other), "first": first, "second": second}


def test_first_process_builds_into_the_cache(runs):
    out, _ = runs["first"]
    assert out["build_dir"] == runs["cache"]
    assert sorted(out["builds"]) == sorted(HOST)
    for name, (seconds, path) in out["builds"].items():
        assert seconds > 0 and os.path.dirname(path) == runs["cache"], name
    assert "no CUDA card" in out["doctor_exit"]


def test_second_process_compiles_nothing(runs):
    first, _ = runs["first"]
    out, _ = runs["second"]
    assert sorted(out["builds"]) == sorted(HOST)
    for name, (seconds, path) in out["builds"].items():
        assert seconds == 0.0 and path == first["builds"][name][1], name


def test_doctor_reports_the_cache(runs):
    _, stdout = runs["first"]
    lines = {ln.split()[1]: ln for ln in stdout.splitlines() if ln.startswith("[doctor]")}
    assert lines["compile_cache"].split()[2] == runs["cache"]
    report = json.loads(next(ln for ln in stdout.splitlines() if ln.startswith("{")))
    assert report["compile_cache"] == runs["cache"] == report["build_dir"]
    assert report["build_dir_cached"] == []
    _, stdout = runs["second"]
    report = json.loads(next(ln for ln in stdout.splitlines() if ln.startswith("{")))
    found = report["build_dir_cached"]
    assert sorted(f.rsplit("_", 1)[0] for f in found) == sorted(f"lib{n}" for n in HOST)
    for name in HOST:
        assert report[f"build_{name}"]["seconds"] == 0.0


def test_mixing_directories_raises(runs):
    out, _ = runs["second"]
    assert runs["other"] in out["mixing"] and "already built or loaded" in out["mixing"]
    assert out["same_again"] == runs["cache"]


def test_forkserver_loader_workers_load_from_the_cache(runs):
    out, _ = runs["second"]
    assert len(out["workers"]) == 4
    for aux in out["workers"]:
        assert aux["build_dir"] == runs["cache"]
        assert aux["letterbox"] == out["builds"]["letterbox"][1]


def test_set_build_dir_in_this_process(tmp_path, monkeypatch):
    assert cuda_build.build_dir() == os.path.join(os.path.dirname(cuda_build.__file__), "_build")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.BUILD_DIR)
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    monkeypatch.setattr(cuda_build, "_BUILDS", {"x": None})
    assert cuda_build.set_build_dir(cuda_build.BUILD_DIR) == cuda_build.BUILD_DIR
    with pytest.raises(RuntimeError, match="already built or loaded \\['x'\\]"):
        cuda_build.set_build_dir(str(tmp_path / "elsewhere"))
    monkeypatch.setattr(cuda_build, "_BUILDS", {})
    assert cuda_build.set_build_dir(str(tmp_path / "elsewhere")) == str(tmp_path / "elsewhere")
    assert os.path.isdir(tmp_path / "elsewhere")
