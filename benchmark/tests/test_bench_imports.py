"""No module that the benchmark runs is JAX's or the JAX package's, and the
plain reference takes nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.run import FORBIDDEN, forbidden_modules

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "benchmark"


def _loaded_after(imports: str) -> list:
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); {imports}; "
            "import json; print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, check=True, timeout=300)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_forbidden_compares_whole_top_level_names():
    assert forbidden_modules(["jax", "jax.numpy", "flax.linen", "optax", "jaxlib.xla",
                              "ieagan_tpu.ops"]) == sorted(
        ["jax", "jax.numpy", "flax.linen", "optax", "jaxlib.xla", "ieagan_tpu.ops"])
    assert forbidden_modules(["ieagan_torch", "ieagan_torch.ops", "jaxtyping", "flaxen",
                              "optaxx", "ieagan_tpu_extra"]) == []
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "optax", "ieagan_tpu"}


def test_the_harness_and_the_program_load_no_jax():
    """Every module of the benchmark, every traffic driver and metric reader
    found on disk, and the program's entries that the drivers call."""
    loads = ["import benchmark.run", "import benchmark.harness.trace",
             "import benchmark.harness.readings", "import benchmark.harness.spans",
             "import benchmark.reference.step",
             "import ieagan_torch.deploy.inference", "import ieagan_torch.train.step",
             "import ieagan_torch.parallel.sharding", "import ieagan_torch.core.precision",
             "import ieagan_torch.models.generator",
             "from benchmark.harness import manifest",
             "[manifest.driver(p.stem) for p in (manifest.HERE / 'traffic').glob('*.py')]",
             "[manifest.reader(p.name[:-3]) for p in (manifest.HERE / 'metrics').glob('*.py')]"]
    loaded = _loaded_after("; ".join(loads))
    assert "ieagan_torch" in loaded
    assert forbidden_modules(loaded) == []


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_after("import benchmark.reference.model, benchmark.reference.step, "
                           "benchmark.work.model_flops, benchmark.work.attention")
    assert [m for m in loaded if m.split(".", 1)[0] == "ieagan_torch"] == []
    assert forbidden_modules(loaded) == []


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py"))
                         + sorted((HERE / "work").glob("*.py")), ids=lambda p: p.name)
def test_the_reference_names_nothing_of_the_program(path):
    tree = ast.parse(path.read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    tops = {n.split(".", 1)[0] for n in names}
    assert not tops & (set(FORBIDDEN) | {"ieagan_torch"}), tops
