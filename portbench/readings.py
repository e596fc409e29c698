"""Readings that set a cell's limits (limits/<cell>.json), on the chip at
the cell's own size:

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3
        --control-seeds 4,5,6 --seconds 5 [--out <file.jsonl>]

For every seed the program runs a short window of the cell's own traffic
and is compared with the reference (the lower readings: sound runs). For
every control seed the control, the reference computed one precision
step below the configuration (TF32 matmul operands, fp8 convolutions),
replays the same frames in the program's place and is compared with the
reference in the same way (the upper readings). One JSON line per
reading, on standard output and in ``--out``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] != ROOT:
    sys.path.insert(0, ROOT)


def readings(manifest, workload, seed, seconds, device, control):
    """[{'seed', 'run', 'values', ...}] of one seed: the program's, and
    with ``control`` the control's on the same frames."""
    import torch
    from portbench.harness import runner
    ctx = runner.make_ctx(manifest, workload, seed, seconds, 0,
                          time.perf_counter(), device)
    driver = manifest.driver(ctx.traffic)
    res = driver.program_run(ctx)
    out = res['outputs']
    gc.collect()
    if torch.device(device).type == 'cuda':
        torch.cuda.empty_cache()
    got = driver.check(ctx, out, res['seeds'], control)
    rows = [dict(seed=seed, run='program', e2e=res['e2e'], info=res['info'],
                 memory_peak_bytes=res['memory_peak_bytes'],
                 values=got['program'])]
    if control:
        # A control that stops gives no number: it has failed.
        rows.append(dict(seed=seed, run='control', values=got['control'])
                    if got['control'] is not None else
                    dict(seed=seed, run='control', crashed=True))
    return rows


def main():
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', default='')
    p.add_argument('--control-seeds', default='')
    p.add_argument('--seconds', type=float, default=5.0)
    p.add_argument('--out')
    args = p.parse_args()
    import torch
    from portbench.harness.manifest import Manifest
    if not torch.cuda.is_available():
        print('readings: no CUDA device', file=sys.stderr)
        return 3
    manifest = Manifest()
    device = torch.device('cuda', 0)

    def ints(text):
        return [int(s) for s in text.split(',') if s]

    plan = ([(s, False) for s in ints(args.seeds)]
            + [(s, True) for s in ints(args.control_seeds)])
    sink = open(args.out, 'a') if args.out else None
    try:
        for seed, control in plan:
            t = time.perf_counter()
            with contextlib.redirect_stdout(sys.stderr):
                rows = readings(manifest, args.workload, seed, args.seconds,
                                device, control)
            for r in rows:
                r['s'] = time.perf_counter() - t
                line = json.dumps(r)
                print(line, flush=True)
                if sink:
                    sink.write(line + '\n')
                    sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == '__main__':
    sys.exit(main())
