"""BENCHMARK.json against the contract's shape, and the harness finding
every piece by name."""
from __future__ import annotations

import hashlib
import json
import re

import pytest

from conftest import ROOT, copy_bench
from portbench.harness.manifest import Manifest

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


@pytest.fixture(scope='module')
def manifest():
    return Manifest(ROOT)


def test_manifest_loads_with_the_contract_keys(manifest):
    d = manifest.data
    assert set(d) == {'command', 'paths', 'run_seconds', 'configs',
                      'workloads', 'end_to_end', 'per_layer'}
    assert d['command'][:2] == ['python3', 'portbench/run.py']
    assert d['paths'] == ['portbench']
    assert 1 <= d['run_seconds'] <= 51
    # A full check of 24 cells fits the driver's 43,200 s.
    runs = 2 + 14 * 24
    assert runs * (d['run_seconds'] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units_use_the_allowed_characters(manifest):
    d = manifest.data
    names = ([c['name'] for c in d['configs']]
             + [w[k] for w in d['workloads'] for k in ('name', 'config',
                                                       'traffic')]
             + [m['name'] for m in d['end_to_end'] + d['per_layer']]
             + [k for c in d['configs'] for k in c['reduced']])
    for n in names:
        assert NAME.match(n), n
    for m in d['end_to_end'] + d['per_layer']:
        assert UNIT.match(m['unit']), m['unit']
        assert m['better'] in ('lower', 'higher')
    for group in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        ns = [x['name'] for x in d[group]]
        assert len(ns) == len(set(ns)), group


def test_every_piece_is_found_by_name(manifest):
    d = manifest.data
    used = {w['config'] for w in d['workloads']}
    assert used == {c['name'] for c in d['configs']}
    for w in d['workloads']:
        assert w['chips'] in (1, 4)
        assert 1 <= len(w['why']) <= 200
        cfg = manifest.config(w)
        assert cfg['name'] == w['config']
        traffic = manifest.traffic(w)
        assert manifest.driver(traffic).run
        assert manifest.limits(w)
    for m in d['per_layer']:
        assert callable(manifest.reader(m['name']).read)


def test_each_moves_is_reported_by_every_cell_it_lists(manifest):
    d = manifest.data
    e2e = {m['name']: m for m in d['end_to_end']}
    for w in d['workloads']:
        names = {m['name'] for m in manifest.end_to_end(w['name'])}
        assert 'setup_s' in names and len(names) >= 2, w['name']
        assert manifest.per_layer(w['name']), w['name']
    for m in d['per_layer']:
        assert m['moves'] in e2e
        for cell in m['workloads']:
            reported = {x['name'] for x in manifest.end_to_end(cell)}
            assert m['moves'] in reported, (m['name'], cell)


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob('*') if p.is_file()
            and '__pycache__' not in p.parts}


def test_new_config_mix_and_metric_are_found_without_editing(tmp_path):
    root = copy_bench(tmp_path)
    before = _digests(root)
    bench = root / 'portbench'
    (bench / 'configs' / 'nuscenes_other.json').write_text(
        (bench / 'configs' / 'nuscenes_oracle.json').read_text()
        .replace('"nuscenes_oracle"', '"nuscenes_other"'))
    mix = json.loads((bench / 'traffic' / 'oracle_6cam.json').read_text())
    mix['frames_in_flight'] = 2
    (bench / 'traffic' / 'oracle_deep.json').write_text(json.dumps(mix))
    (bench / 'limits' / 'nuscenes_other.deep.json').write_text(
        (bench / 'limits' / 'nuscenes_oracle_6cam.json').read_text())
    (bench / 'metrics' / 'frames_per_s.py').write_text(
        'def read(rec):\n    return rec["frames"] / rec["window_s"]\n')
    # BENCHMARK.json is the one file a new cell adds entries to.
    d = json.loads((root / 'BENCHMARK.json').read_text())
    d['configs'].append(dict(d['configs'][0], name='nuscenes_other',
                             file='portbench/configs/nuscenes_other.json'))
    d['workloads'].append(dict(d['workloads'][0], name='nuscenes_other.deep',
                               config='nuscenes_other',
                               traffic='oracle_deep'))
    d['per_layer'].append(dict(d['per_layer'][0], name='frames_per_s',
                               unit='frames/s', workloads=[
                                   'nuscenes_other.deep']))
    (root / 'BENCHMARK.json').write_text(json.dumps(d))
    after = _digests(root)
    changed = [p for p in before if before[p] != after[p]]
    assert [str(p) for p in changed] == ['BENCHMARK.json']
    m = Manifest(root)
    cell = m.cell('nuscenes_other.deep')
    assert m.config(cell)['name'] == 'nuscenes_other'
    assert m.traffic(cell)['frames_in_flight'] == 2
    assert m.limits(cell)
    assert [x['name'] for x in m.per_layer(cell['name'])] == ['frames_per_s']
    assert m.reader('frames_per_s').read(dict(frames=10, window_s=2.0)) == 5
