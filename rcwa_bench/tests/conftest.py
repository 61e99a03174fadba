"""Tiny copies of the benchmark's cells for the CPU: the same drivers,
comparisons, metrics and limits, on configurations and traffic cut to a
size the plain kernel versions solve in seconds."""

import json
import os
import shutil

import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def _load(path):
    with open(path) as f:
        return json.load(f)


def _dump(obj, path):
    with open(path, 'w') as f:
        json.dump(obj, f)


@pytest.fixture(scope='session', autouse=True)
def few_threads():
    torch.set_num_threads(2)


@pytest.fixture
def tiny(tmp_path):
    """(root, here): a checkout root with a BENCHMARK.json whose
    configurations are cut to a 48 x 48 raster, and a benchmark folder
    whose traffic is cut to order 1 and 5 wavelengths a batch; drivers,
    comparisons, references, metrics and limits are the benchmark's own."""
    root, here = tmp_path / 'root', tmp_path / 'here'
    (root / 'cfg').mkdir(parents=True)
    (here / 'traffic').mkdir(parents=True)
    for d in ('drivers', 'metrics', 'compare', 'limits', 'reference'):
        shutil.copytree(os.path.join(BENCH, d), here / d)
    bench = _load(os.path.join(ROOT, 'BENCHMARK.json'))
    for c in bench['configs']:
        cfg = _load(os.path.join(ROOT, c['file']))
        cfg['grid'] = [48, 48]
        if 'order' in cfg:
            cfg['order'] = [1, 1]
        # a 6 nm pixel: soften the edges so W moves the raster in float32
        cfg['edge_sharpness'] = 50
        c['file'] = 'cfg/' + c['name'] + '.json'
        _dump(cfg, root / c['file'])
    _dump(bench, root / 'BENCHMARK.json')
    for t in os.listdir(os.path.join(BENCH, 'traffic')):
        tr = _load(os.path.join(BENCH, 'traffic', t))
        if 'order' in tr:
            tr['order'] = 1
            tr['batch'] = min(tr['batch'], 5)
            tr['check_sample'] = min(tr['check_sample'], 3)
            tr['ref_block'] = 5
        tr['trace_units'] = 2
        _dump(tr, here / 'traffic' / t)
    return str(root), str(here)
