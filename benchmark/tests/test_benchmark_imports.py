"""Nothing the benchmark runs loads the JAX side, compared by whole
top-level names (the port's own name begins with the JAX package's), and
the plain reference loads nothing of the port."""

import ast
import json
import subprocess
import sys

from benchmark.harness import BENCH, FORBIDDEN, ROOT

PROBE = """
import json, sys, torch
sys.path.insert(0, {root!r})
torch.set_num_threads(1)
from benchmark import harness
from benchmark.tests import tiny
for make in (tiny.search, tiny.serve):
    cell, cfg, tr = make()
    harness.run_on("cpu", cell, cfg, tr, 3, 0.1)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(ROOT), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_side_module():
    top = _modules(PROBE.format(root=str(ROOT)))
    assert "tfnas_tpu_torch" in top  # the port is what runs
    assert not top & set(FORBIDDEN), top & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_port():
    code = ("import json, sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.nn, benchmark.reference.supernet, "
            "benchmark.reference.steps, benchmark.reference.evalnet, "
            "benchmark.reference.draws, benchmark.reference.augment, "
            "benchmark.reference.lowp, benchmark.flops, benchmark.compare, "
            "benchmark.jpegs\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in "
            "sys.modules})))" % str(ROOT))
    top = _modules(code)
    assert not top & ({"tfnas_tpu_torch"} | set(FORBIDDEN))


def test_reference_sources_import_only_plain_modules():
    for path in sorted((BENCH / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in (
                    {"tfnas_tpu_torch"} | set(FORBIDDEN)), (path, n)
