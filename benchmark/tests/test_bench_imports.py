"""A run holds no module whose top-level name is jax, jaxlib, flax or the
JAX package (compared whole: the port's name begins with the JAX
package's), and a run that holds one prints no result."""

import subprocess
import sys
import types

from benchmark import harness
from benchmark.tests import cut

SCRIPT = """
import sys
sys.path.insert(0, {root!r})
from benchmark.tests import cut
from benchmark import harness
code, res = cut.run("sintel1024.passes")
assert code == 0 and res["correct"]
print("MODULES", sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    out = subprocess.run([sys.executable, "-c",
                          SCRIPT.format(root=harness.ROOT)],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = [s for s in out.stdout.splitlines() if s.startswith("MODULES")][0]
    tops = set(eval(line[len("MODULES "):]))
    assert "arap_flow_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "arap_flow_tpu"}


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "arap_flow_tpu_torch_x",
                        types.ModuleType("arap_flow_tpu_torch_x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "arap_flow_tpu.ops",
                        types.ModuleType("arap_flow_tpu.ops"))
    assert harness.forbidden_modules() == ["arap_flow_tpu"]


def test_a_run_holding_jax_prints_no_result(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    code, res = cut.run("sintel1024.passes")
    assert code != 0 and res is None
