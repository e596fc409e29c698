"""The readers of the program's spans: None on an empty registry and on
a program without one, the mean of their spans on a filled one, and
filled by a tiny traced run of the oracle cell on the CPU."""
from __future__ import annotations

import pytest

from conftest import ROOT, tiny_ctx
from portbench.harness import runner
from portbench.harness.manifest import Manifest

READERS = ['upload_ms', 'paint_insert_ms', 'tracker_ms', 'harvest_ms',
           'sync_wait_ms']


def _span(n, total_ms, device_ms=None, under=None):
    return dict(n=n, total_ms=total_ms, self_ms=total_ms,
                device_ms=device_ms, under=under or {})


# A traced stretch of 4 frames and 3 samples.
FILLED = dict(counters={}, spans={
    'upload': _span(4, 40.0),
    'integrate': _span(4, 320.0),
    'track': _span(4, 2.0),
    'paint': _span(4, 1.0, device_ms=2.0),
    'insert': _span(4, 1.0, device_ms=1.2, under={'integrate': 1.0}),
    'harvest': _span(3, 30.0),
    'sync.painted': _span(7, 260.0, under={'integrate': 250.0,
                                           'harvest': 10.0}),
    'sync.fetch': _span(3, 3.0, under={'harvest': 3.0}),
})
WANT = dict(upload_ms=10.0, paint_insert_ms=0.8, tracker_ms=0.5,
            harvest_ms=(30.0 - 13.0) / 3, sync_wait_ms=62.5)


@pytest.fixture
def profiling():
    from pc_accumulation_lib_tpu_torch.utils import profiling
    profiling.reset()
    yield profiling
    profiling.reset()


@pytest.mark.parametrize('name', READERS)
def test_reader_on_an_empty_registry_is_none(profiling, name):
    assert Manifest(ROOT).reader(name).read({}) is None


@pytest.mark.parametrize('name', READERS)
def test_reader_without_a_registry_is_none(profiling, monkeypatch, name):
    monkeypatch.delattr(profiling, 'snapshot')
    assert Manifest(ROOT).reader(name).read({}) is None


@pytest.mark.parametrize('name', READERS)
def test_reader_is_the_mean_of_its_spans(profiling, monkeypatch, name):
    monkeypatch.setattr(profiling, 'snapshot', lambda: FILLED)
    assert Manifest(ROOT).reader(name).read({}) == pytest.approx(WANT[name])


def test_a_traced_tiny_run_reads_every_reader(profiling, tiny_root):
    out = runner.run_cell(tiny_ctx(tiny_root, 'nuscenes_oracle_6cam',
                                   trace=1))
    got = out['metrics']
    for name in READERS:
        assert name in got and got[name]['value'] >= 0, (name, got)
    for name in ('semseg_ms', 'raster_ms', 'mfu.bev'):
        assert name in got, (name, got)
