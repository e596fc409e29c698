"""One run of one cell: find its pieces, check the device, run the
driver, read the per-layer metrics, judge the compared numbers and print
the result line."""
from __future__ import annotations

import contextlib
import gc
import json
import sys
import time
import types

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'pc_accumulation_lib_tpu')


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name (before the first dot, whole)
    is JAX's or the JAX package's."""
    return sorted({m for m in modules if m.split('.')[0] in FORBIDDEN})


def make_ctx(manifest, workload, seed, seconds, trace, t_start, device):
    cell = manifest.cell(workload)
    traffic = manifest.traffic(cell)
    return types.SimpleNamespace(
        manifest=manifest, cell=cell, config=manifest.config(cell),
        traffic=traffic, limits=manifest.limits(cell), seed=int(seed),
        seconds=float(seconds), trace=bool(trace), t_start=t_start,
        device=device)


def run_cell(ctx) -> dict:
    """Drive the cell and judge it. Returns the result line's fields and
    the compared rows (no device check: tests call this on the CPU)."""
    from portbench.reference.compare import judge
    import torch
    driver = ctx.manifest.driver(ctx.traffic)
    res = driver.run(ctx)
    gc.collect()
    if torch.device(ctx.device).type == 'cuda':
        torch.cuda.empty_cache()
    rows, ok = judge(res['values'], ctx.limits)
    name = ctx.cell['name']
    metrics = {}
    if ctx.trace:
        for m in ctx.manifest.per_layer(name):
            v = ctx.manifest.reader(m['name']).read(res['record'])
            if v is not None:
                metrics[m['name']] = dict(value=v, unit=m['unit'])
    else:
        for m in ctx.manifest.end_to_end(name):
            metrics[m['name']] = dict(value=res['e2e'][m['name']],
                                      unit=m['unit'])
    return dict(correct=ok, attempted=res['attempted'],
                failed=res['failed'], metrics=metrics, rows=rows,
                memory_peak_bytes=res['memory_peak_bytes'],
                record=res['record'], info=res.get('info', {}))


def main(args, t_start) -> int:
    from portbench.harness.manifest import Manifest
    manifest = Manifest()
    try:
        manifest.cell(args.workload)
    except KeyError as e:
        print(e, file=sys.stderr)
        return 2
    import torch
    chips = manifest.cell(args.workload)['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'portbench: the cell needs {chips} CUDA device(s); '
              f'available={torch.cuda.is_available()}, '
              f'count={torch.cuda.device_count()}', file=sys.stderr)
        return 3
    ctx = make_ctx(manifest, args.workload, args.seed, args.seconds,
                   args.trace, t_start, torch.device('cuda', 0))
    # The program prints progress; standard output keeps the result.
    with contextlib.redirect_stdout(sys.stderr):
        out = run_cell(ctx)
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f'portbench: loaded in the measuring process: {bad}',
              file=sys.stderr)
        return 4
    device = dict(platform='gpu', kind=torch.cuda.get_device_name(0),
                  count=chips, memory_peak_bytes=out['memory_peak_bytes'])
    line = dict(correct=out['correct'], attempted=out['attempted'],
                failed=out['failed'], metrics=out['metrics'], device=device)
    rec = out['record']
    if args.trace:
        tr = rec['trace']
        device.update(busy_s=tr['busy_s'], window_s=tr['window_s'])
        line['breakdown'] = dict(device_ops=tr['device_ops'],
                                 idle_gaps=tr['idle_gaps'])
    print(json.dumps(dict(info=out['info'], seconds_total=time.perf_counter()
                          - t_start)), file=sys.stderr)
    line['compared'] = {n: dict(value=v, limit=lim)
                        for n, v, lim in out['rows']}
    for n, v, lim in out['rows']:
        print(f'compared {n}: {v!r} (limit {lim!r})', file=sys.stderr)
    print(json.dumps(line))
    return 0
