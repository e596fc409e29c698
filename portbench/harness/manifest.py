"""Find a cell's pieces by name: BENCHMARK.json at the checkout's root,
the configuration file it names, the traffic mix in traffic/<name>.json,
the driver that mix names in drivers/<driver>.py, the cell's limits in
limits/<cell>.json and each per-layer metric's reader in
metrics/<metric>.py. Adding a cell, a mix or a metric adds files; no
file here needs an edit."""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = 'portbench'


class Manifest:
    def __init__(self, root=ROOT):
        self.root = Path(root)
        self.data = json.loads((self.root / 'BENCHMARK.json').read_text())
        self.dir = self.root / BENCH_DIR

    def cell(self, name: str) -> dict:
        for w in self.data['workloads']:
            if w['name'] == name:
                return w
        raise KeyError(f'no workload {name!r} in BENCHMARK.json')

    def config(self, cell: dict) -> dict:
        for c in self.data['configs']:
            if c['name'] == cell['config']:
                return json.loads((self.root / c['file']).read_text())
        raise KeyError(f'no configuration {cell["config"]!r}')

    def traffic(self, cell: dict) -> dict:
        return json.loads(
            (self.dir / 'traffic' / f'{cell["traffic"]}.json').read_text())

    def limits(self, cell: dict) -> dict:
        return json.loads(
            (self.dir / 'limits' / f'{cell["name"]}.json').read_text())

    def driver(self, traffic: dict):
        return importlib.import_module(
            f'portbench.drivers.{traffic["driver"]}')

    def _applies(self, metric: dict, cell_name: str, e2e_names) -> bool:
        if 'workloads' in metric:
            return cell_name in metric['workloads']
        return e2e_names is None or metric.get('moves') in e2e_names

    def end_to_end(self, cell_name: str) -> list:
        return [m for m in self.data['end_to_end']
                if self._applies(m, cell_name, None)]

    def per_layer(self, cell_name: str) -> list:
        e2e = {m['name'] for m in self.end_to_end(cell_name)}
        return [m for m in self.data['per_layer']
                if self._applies(m, cell_name, e2e)]

    def reader(self, metric_name: str):
        """The module metrics/<name>.py (names may hold dots)."""
        path = self.dir / 'metrics' / f'{metric_name}.py'
        spec = importlib.util.spec_from_file_location(
            'portbench_metric_' + metric_name.replace('.', '_')
            .replace('-', '_'), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
