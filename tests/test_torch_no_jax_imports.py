"""The PyTorch port stays free of JAX and of the JAX package.

The card machine has no JAX, and the port keeps its own copies of the
host modules it shares with the JAX package (config, utils, dataloaders,
ops/trajectory, bev/viz). Two passes: a static one over the source of
every module of the port and of chip_smoke.py (imports at any depth,
lazy ones inside functions included), and a runtime one that imports
every module of the port in a fresh interpreter and reads sys.modules.
"""
import ast
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = 'pc_accumulation_lib_tpu_torch'
FORBIDDEN = ('jax', 'jaxlib', 'pc_accumulation_lib_tpu')


def _sources():
    out = ['chip_smoke.py']
    for d, _, names in os.walk(os.path.join(REPO, PORT)):
        out += [os.path.relpath(os.path.join(d, n), REPO)
                for n in names if n.endswith('.py')]
    return sorted(out)


def _forbidden(module):
    return module.split('.')[0] in FORBIDDEN


def _imports(tree):
    """(line, module) of every import statement in the tree."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ''
        elif (isinstance(node, ast.Call)
              and getattr(node.func, 'attr', getattr(node.func, 'id', ''))
              in ('import_module', '__import__')
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


def test_sources_found():
    srcs = _sources()
    assert 'chip_smoke.py' in srcs
    assert f'{PORT}/ops/segmented_stats.py' in srcs
    assert len(srcs) > 20


@pytest.mark.parametrize('path', _sources())
def test_no_jax_import_in_source(path):
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = [(line, mod) for line, mod in _imports(tree) if _forbidden(mod)]
    assert not bad, f'{path} imports {bad}'


@pytest.mark.parametrize('source, expect', [
    ('import jax.numpy as jnp', True),
    ('from jax import lax', True),
    ('def f():\n    from pc_accumulation_lib_tpu.utils import io', True),
    ('import pc_accumulation_lib_tpu', True),
    ('importlib.import_module("pc_accumulation_lib_tpu.config")', True),
    ('from pc_accumulation_lib_tpu_torch import config', False),
    ('import pc_accumulation_lib_tpu_torch.ops.icp', False),
    ('from . import core', False),
])
def test_static_pass_catches_imports(source, expect):
    """The static pass sees top-level, lazy and dynamic imports of the
    JAX package, and lets the port's own imports through."""
    found = [m for _, m in _imports(ast.parse(source)) if _forbidden(m)]
    assert bool(found) == expect, (source, found)


# The NuScenes slice's modules, each of which the fresh interpreter must
# import.
NUSCENES_MODULES = (
    'accum.tracking', 'accum.nuscenes_oracle', 'accum.nuscenes',
    'dataloaders.nuscenes', 'dataloaders.nuscenes_utils',
    'dataloaders.lanemap', 'parallel.manifest', 'utils.ply',
    'runners.nuscenes_bev_gen', 'runners.nuscenes_oracle_bev_gen')


def test_importing_every_module_loads_no_jax():
    script = f'''
import importlib, json, pkgutil, sys
import {PORT}
names = [m.name for m in pkgutil.walk_packages({PORT}.__path__,
                                               '{PORT}.')]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in {FORBIDDEN!r})
print(json.dumps(dict(names=names, bad=bad)))
sys.exit(1 if bad else 0)
'''
    proc = subprocess.run([sys.executable, '-c', script], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    names = json.loads(proc.stdout.splitlines()[-1])['names']
    assert len(names) > 20, names
    missing = [m for m in NUSCENES_MODULES if f'{PORT}.{m}' not in names]
    assert not missing, missing
