"""The PyTorch port stands alone: it imports neither jax nor anything of
the JAX package ``lzani_tpu``. conftest.py imports jax into this process,
so the checks of ``sys.modules`` run in a fresh interpreter; an ``ast``
scan of the port's sources and ``chip_smoke.py`` covers imports that no
run reaches."""
import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CODE = """
import sys
import lzani_tpu_torch, lzani_tpu_torch.ops.cuda_engine, lzani_tpu_torch.cli
import lzani_tpu_torch.matcher, lzani_tpu_torch.synth, lzani_tpu_torch.ops.hybrid
import lzani_tpu_torch.ops.engine_jax, lzani_tpu_torch.ops.fold_stats
import lzani_tpu_torch.parallel.mesh
bad = sorted(m for m in sys.modules
             if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'lzani_tpu.ops')))
assert not bad, bad
assert 'torch' in sys.modules
print('ok')
"""

# every module of the port, then its native CLI run as ``python -m``
WALK = """
import importlib, pkgutil, runpy, sys
import lzani_tpu_torch
from lzani_tpu_torch import synth
names = [m.name for m in pkgutil.walk_packages(lzani_tpu_torch.__path__,
                                               'lzani_tpu_torch.')]
for name in names:
    if name != 'lzani_tpu_torch.__main__':
        importlib.import_module(name)
fa, out = sys.argv[1], sys.argv[2]
codes = synth.small_family(3)
synth.write_fasta(fa, [f's{k}' for k in range(len(codes))], codes)
sys.argv = ['lzani_tpu_torch', 'all2all', '--in-fasta', fa, '--out', out,
            '-t', '2', '-V', '0', '--backend', 'native']
try:
    runpy.run_module('lzani_tpu_torch', run_name='__main__')
except SystemExit as e:
    assert e.code == 0, e.code
bad = sorted(m for m in sys.modules if m in ('jax', 'lzani_tpu')
             or m.startswith(('jax.', 'jaxlib', 'lzani_tpu.')))
assert not bad, bad
print(len(names), open(out).read().count(chr(10)))
"""

# the native backend needs neither torch nor a card
NATIVE = """
import runpy, sys
from lzani_tpu_torch import synth
fa, out = sys.argv[1], sys.argv[2]
codes = synth.small_family(4)
synth.write_fasta(fa, [f's{k}' for k in range(len(codes))], codes)
sys.argv = ['lzani_tpu_torch', 'all2all', '--in-fasta', fa, '--out', out,
            '-V', '0', '--backend', 'native']
try:
    runpy.run_module('lzani_tpu_torch', run_name='__main__')
except SystemExit as e:
    assert e.code == 0, e.code
assert 'torch' not in sys.modules
print('ok')
"""


def _env():
    return {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


def test_port_imports_no_jax():
    res = subprocess.run([sys.executable, "-c", CODE], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_every_module_and_the_native_cli_import_nothing_of_jax(tmp_path):
    res = subprocess.run([sys.executable, "-c", WALK,
                          str(tmp_path / "in.fna"), str(tmp_path / "o.tsv")],
                         cwd=ROOT, env=_env(), capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    n_modules, n_lines = map(int, res.stdout.split())
    assert n_modules >= 15 and n_lines == 1 + 6 * 5   # header + pairs


def test_native_cli_loads_no_torch(tmp_path):
    res = subprocess.run([sys.executable, "-c", NATIVE,
                          str(tmp_path / "in.fna"), str(tmp_path / "o.tsv")],
                         cwd=ROOT, env=_env(), capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def _sources():
    pkg = os.path.join(ROOT, "lzani_tpu_torch")
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _is_jax_package(name: str) -> bool:
    return (name in ("jax", "jaxlib", "lzani_tpu")
            or name.startswith(("jax.", "jaxlib.", "lzani_tpu.")))


def test_sources_import_nothing_of_jax():
    """No ``import``/``from`` of jax or lzani_tpu, and no ``-m lzani_tpu...``
    command line, in any source of the port or in chip_smoke.py."""
    bad = []
    for path in _sources():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                bad += [(path, a.name) for a in node.names
                        if _is_jax_package(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                if _is_jax_package(node.module or ""):
                    bad.append((path, node.module))
            elif isinstance(node, (ast.List, ast.Tuple)):
                strs = [e.value if isinstance(e, ast.Constant) else None
                        for e in node.elts]
                for a, b in zip(strs, strs[1:]):
                    if a == "-m" and isinstance(b, str) and _is_jax_package(b):
                        bad.append((path, f"-m {b}"))
    assert not bad, bad
    assert len(list(_sources())) >= 20
