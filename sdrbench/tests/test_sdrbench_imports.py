"""The import check compares whole top-level names; the reference loads
nothing of the program; no file of the benchmark names JAX, the JAX
package, or the JAX package's own benchmarks."""

import re
import subprocess
import sys
import types
from pathlib import Path

from sdrbench import run as R


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    for name in ("supersdr_tpu_torch_extra", "jaxtyping", "flaxen.x"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert R.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "supersdr_tpu.ops",
                        types.ModuleType("supersdr_tpu.ops"))
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert R.forbidden_modules() == ["jax", "supersdr_tpu"]


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; import sdrbench.reference.pipeline, "
            "sdrbench.reference.precision, sdrbench.reference.design, "
            "sdrbench.reference.modes.am; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'supersdr_tpu_torch', 'supersdr_tpu', 'jax', 'jaxlib'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=R.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_sources_name_no_jax_and_no_jax_benchmarks():
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|supersdr_tpu)"
                     r"(\s|\.|$)", re.M)
    for path in R.BENCH.rglob("*.py"):
        if path.name == Path(__file__).name:
            continue
        text = path.read_text()
        assert not bad.search(text), path
        for other in ("benchmarks/", "bench.py\"", "import bench"):
            assert other not in text, (path, other)
    ref = R.BENCH / "reference"
    for path in ref.rglob("*.py"):
        assert "supersdr_tpu_torch" not in path.read_text(), path
