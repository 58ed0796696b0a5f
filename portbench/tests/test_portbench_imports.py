"""Nothing the benchmark runs loads JAX or the JAX package (top-level
names compared whole), and the reference loads nothing of the port."""

import ast
import json
import subprocess
import sys

from portbench.tests.conftest import ROOT

RUN_SMALL = """
import json, sys, torch
from portbench.tests.conftest import small_cell
from portbench import run
run.run_cell(small_cell("scene2.train"), 1, 0.3, True, torch.device("cpu"))
run.run_cell(small_cell("scene2.render"), 1, 0.3, True, torch.device("cpu"))
print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""


def _top_levels(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    tops = _top_levels(RUN_SMALL)
    assert "ray_tracing_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "ray_tracing_tpu"}


def test_reference_loads_nothing_of_the_port():
    tops = _top_levels("import json, sys\n"
                       "import portbench.reference.pathtracer, portbench.reference.train\n"
                       "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))")
    assert not tops & {"ray_tracing_tpu_torch", "ray_tracing_tpu", "jax"}
    for path in (ROOT / "portbench/reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] in ("torch", "dataclasses", "math", "__future__",
                                           "portbench"), (path.name, n)
                assert not n.startswith("portbench.") or n.startswith("portbench.reference")
