"""No module the benchmark runs imports jax, jaxlib, flax or the JAX
package ``lzani_tpu`` (top-level names compared whole, so the port
``lzani_tpu_torch`` is not mistaken for it), and the reference imports
nothing of the port."""

import ast
import glob
import os
import subprocess
import sys

from benchmark import harness

RUN = """
import sys, glob, os
sys.path.insert(0, sys.argv[1])
from benchmark import harness, check, control, generate, hostload, trace, work
from benchmark.reference import lz, tsv
cell = harness.load_cell(sys.argv[1], 'viral-cuda')
for m in cell['end_to_end'] + cell['per_layer']:
    harness.load_reader(sys.argv[1], m['name'])
from lzani_tpu_torch import matcher
from lzani_tpu_torch.ops import cuda_engine
print(','.join(harness.forbidden_modules()))
"""

REFERENCE = """
import sys
sys.path.insert(0, sys.argv[1])
from benchmark import check
from benchmark.reference import lz, tsv
print(','.join(sorted(m for m in sys.modules
                      if m.split('.')[0] == 'lzani_tpu_torch')))
"""


def _python(code):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code, harness.ROOT],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    return res.stdout.strip()


def test_the_benchmark_imports_nothing_of_jax():
    assert _python(RUN) == ""


def test_forbidden_names_are_compared_whole():
    saved = dict(sys.modules)
    try:
        sys.modules["lzani_tpu_torch_x"] = sys
        sys.modules["jaxlike"] = sys
        assert "lzani_tpu_torch_x" not in harness.forbidden_modules()
        sys.modules["lzani_tpu.ops"] = sys
        assert "lzani_tpu.ops" in harness.forbidden_modules()
    finally:
        for k in set(sys.modules) - set(saved):
            del sys.modules[k]


def test_the_reference_imports_nothing_of_the_port():
    assert _python(REFERENCE) == ""


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_names_jax_and_the_reference_names_no_port():
    srcs = [p for p in glob.glob(os.path.join(harness.BENCH_DIR, "**", "*.py"),
                                 recursive=True)
            if os.sep + "tests" + os.sep not in p]
    for path in srcs:
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), path
    for name in ("reference/lz.py", "reference/tsv.py", "check.py",
                 "generate.py", "work.py", "trace.py", "hostload.py"):
        tops = {m.split(".")[0] for m in _imports(
            os.path.join(harness.BENCH_DIR, name))}
        assert "lzani_tpu_torch" not in tops, name
