"""The import guard: nothing the harness loads is JAX or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the reference reaches nothing of the port."""

import ast
import os
import subprocess
import sys

import pytest

from rcwa_bench import harness

BENCH = harness.HERE
ROOT = os.path.dirname(BENCH)

_ALL = """
import glob, importlib, json, os, sys
sys.path.insert(0, {root!r})
from rcwa_bench import harness, control, trace, peaks, inputs
for kind in ('drivers', 'metrics', 'compare', 'reference'):
    for p in sorted(glob.glob(os.path.join({bench!r}, kind, '*.py'))):
        name = os.path.basename(p)[:-3]
        if name != '__init__':
            importlib.import_module('rcwa_bench.%s.%s' % (kind, name))
sys.argv = ['run.py']
import runpy
runpy.run_path(os.path.join({bench!r}, 'run.py'), run_name='not_main')
print(json.dumps(sorted(sys.modules)))
"""

_REF = """
import glob, importlib, json, os, sys
sys.path.insert(0, {root!r})
for kind in ('reference', 'compare'):
    for p in sorted(glob.glob(os.path.join({bench!r}, kind, '*.py'))):
        name = os.path.basename(p)[:-3]
        if name != '__init__':
            importlib.import_module('rcwa_bench.%s.%s' % (kind, name))
print(json.dumps(sorted(sys.modules)))
"""


def _loaded(code):
    p = subprocess.run([sys.executable, '-c', code.format(root=ROOT,
                                                          bench=BENCH)],
                       capture_output=True, text=True, timeout=300,
                       cwd=ROOT)
    assert p.returncode == 0, p.stderr
    import json
    return json.loads(p.stdout.strip().splitlines()[-1])


def _tops(mods):
    return {m.split('.')[0] for m in mods}


def test_nothing_the_harness_loads_is_jax_or_the_jax_package():
    tops = _tops(_loaded(_ALL))
    assert 'torcwa_tpu_torch' in tops           # the port is loaded
    assert not tops & set(harness.BANNED), tops & set(harness.BANNED)


def test_the_reference_reaches_nothing_of_the_port():
    """The plain reference, the configurations' reference modules and the
    comparisons load nothing of the port."""
    tops = _tops(_loaded(_REF))
    assert 'torch' in tops
    assert not tops & {'torcwa_tpu_torch', *harness.BANNED}
    for d, f in [(d, f) for d in ('reference', 'compare')
                 for f in os.listdir(os.path.join(BENCH, d))]:
        src = os.path.join(BENCH, d)
        if not f.endswith('.py'):
            continue
        with open(os.path.join(src, f)) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or '']
                assert node.level == 0 or node.module is None or \
                    not node.module.startswith('torcwa'), f
            else:
                continue
            for n in names:
                assert n.split('.')[0] not in {'torcwa_tpu_torch',
                                               *harness.BANNED}, (f, n)


def test_the_guard_sees_the_jax_package_by_its_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, 'torcwa_tpu_torch_like', sys)
    assert harness.banned_modules() == []
    monkeypatch.setitem(sys.modules, 'torcwa_tpu.fmm', sys)
    assert harness.banned_modules() == ['torcwa_tpu']


_LOADS_BANNED = '''

_readings = readings


def readings(*args):
    import sys
    import types
    sys.modules.setdefault('torcwa_tpu', types.ModuleType('torcwa_tpu'))
    return _readings(*args)
'''


def test_a_banned_module_loaded_by_the_comparison_stops_the_run(
        tiny, capsys):
    """The guard runs after the comparison: a comparison that loads a
    module named ``torcwa_tpu`` (a stand-in, not the JAX package) gives no
    result."""
    root, here = tiny
    with open(os.path.join(here, 'compare', 'sweep.py'), 'a') as f:
        f.write(_LOADS_BANNED)
    had = 'torcwa_tpu' in sys.modules
    try:
        with pytest.raises(harness.CellError, match='torcwa_tpu'):
            harness.run_cell('ex1_sweep_o7', 5, 0.2, False, root=root,
                             device='cpu', here=here)
    finally:
        if not had:
            sys.modules.pop('torcwa_tpu', None)
    assert capsys.readouterr().out == ''
