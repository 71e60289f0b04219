"""The port's boundary: what opentsdb_tpu_torch may import, and where it runs.

* No file of opentsdb_tpu_torch/, nor chip_smoke.py, imports jax or the
  JAX package (an AST scan), and the port imports and answers a query in
  a process where both are blocked.
* Entry points run on CUDA unless the caller asks for the CPU: TSDB()
  raises on a box without a card, TSDB(device="cpu") works, and a kernel
  that is asked for without a card raises instead of computing.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

from opentsdb_tpu_torch.core import TSDB
from opentsdb_tpu_torch.ops import kernels
from opentsdb_tpu_torch.utils.config import Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "opentsdb_tpu_torch")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PORT):
        out.extend(os.path.join(root, f) for f in files if f.endswith(".py"))
    return sorted(out)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top == "jax" or top == "jaxlib" or top == "opentsdb_tpu"


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_file_imports_neither_jax_nor_reference(path):
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__"):
            bad += [a.value for a in node.args if isinstance(
                a, ast.Constant) and isinstance(a.value, str)
                and _forbidden(a.value)]
    assert bad == []


_BLOCKED_RUN = r'''
import importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "opentsdb_tpu"):
            raise ImportError("blocked: " + name)
        return None

for mod in list(sys.modules):
    if mod.split(".")[0] in ("jax", "jaxlib", "opentsdb_tpu"):
        del sys.modules[mod]
sys.meta_path.insert(0, Block())

import opentsdb_tpu_torch
for info in pkgutil.walk_packages(opentsdb_tpu_torch.__path__,
                                  "opentsdb_tpu_torch."):
    importlib.import_module(info.name)
import chip_smoke  # noqa: F401

from opentsdb_tpu_torch.core import TSDB
from opentsdb_tpu_torch.models import TSQuery, parse_m_subquery
from opentsdb_tpu_torch.utils.config import Config
tsdb = TSDB(Config({"tsd.core.auto_create_metrics": True}), device="cpu")
for i in range(6):
    tsdb.add_point("m", 1356998400 + 10 * i, i, {"host": "a"})
    tsdb.add_point("m", 1356998400 + 10 * i, 2 * i, {"host": "b"})
q = TSQuery(start="1356998400", end="1356998460",
            queries=[parse_m_subquery("sum:30s-avg:m")])
q.validate()
res = tsdb.new_query_runner().run(q)
print(sorted(res[0].to_json()["dps"].items()))
assert not any(m.split(".")[0] in ("jax", "jaxlib", "opentsdb_tpu")
               for m in sys.modules)
'''


def test_port_runs_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == \
        "[('1356998400', 3.0), ('1356998430', 12.0)]"


def test_tsdb_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this box has a card: TSDB() runs on it")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        TSDB()
    with pytest.raises(RuntimeError):
        TSDB(device="cuda")


def test_tsdb_on_cpu_when_asked():
    tsdb = TSDB(Config({"tsd.core.auto_create_metrics": True}), device="cpu")
    assert tsdb.device.type == "cpu"
    tsdb.add_point("m", 1356998400, 1, {"host": "a"})
    assert tsdb.store.total_datapoints == 1


def test_kernel_library_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this box has a card: the kernels build here")
    for name in kernels.SIGNATURES:
        with pytest.raises(RuntimeError):
            kernels.library(name)
    assert all(n == 0 for n in kernels.LAUNCHES.values())


def test_parallel_package_is_within_the_boundary():
    """The device mesh's package is among the files scanned above, and a
    meshed query answers in a process where jax and the JAX package are
    blocked, as the single-device one does."""
    names = {os.path.relpath(p, PORT) for p in _port_files()}
    assert {os.path.join("parallel", f) for f in (
        "__init__.py", "mesh.py", "collectives.py", "sharded.py",
        "distributed.py")} <= names
    script = _BLOCKED_RUN.replace(
        'tsdb = TSDB(Config({"tsd.core.auto_create_metrics": True}), '
        'device="cpu")',
        'from opentsdb_tpu_torch.parallel import make_mesh\n'
        'tsdb = TSDB(Config({"tsd.core.auto_create_metrics": True, '
        '"tsd.query.mesh.min_series": 0}), device="cpu", '
        'mesh=make_mesh(devices=["cpu"] * 4))')
    script = script.replace(
        "res = tsdb.new_query_runner().run(q)",
        "runner = tsdb.new_query_runner()\nres = runner.run(q)\n"
        "assert runner.exec_stats['meshDevices'] == 4.0")
    assert "make_mesh" in script and "meshDevices" in script
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == \
        "[('1356998400', 3.0), ('1356998430', 12.0)]"
