"""Semantic-segmentation training entry point.

Counterpart of runners/train_semseg.py: trains the ResNet-50 FCN
(models/train.py) on (image, label) pairs, with a checkpoint every
``ckpt_every`` steps and at the end (models/checkpoint.py). In a process
group (parallel/mesh.initialize_multihost) every rank runs run() with the
same arguments and trains on a ('data', 'model') mesh of (dp, world /
dp), as the JAX runner lays its devices out: data parallel over 'data',
the rest of the ranks tensor parallel over 'model'; the rank at data 0
and model 0 writes the checkpoints.

Data format: .npz shards with arrays ``images`` (N,H,W,3) uint8 and
``labels`` (N,H,W) int (255 = ignore), e.g. produced by projecting
KITTI-360 3D semantic GT into the camera.

CLI: python -m pc_accumulation_lib_tpu_torch.runners.train_semseg
'<data_glob>' [--steps N] [--device cuda] [--dp N]
[--coordinator_address host:port --num_processes N --process_id I].
On every card of a host, one process per card, as the JAX runner takes
every chip of its host:
python -m torch.distributed.run --standalone --nproc-per-node N
-m pc_accumulation_lib_tpu_torch.runners.train_semseg '<data_glob>'
(the process group is joined from torchrun's variables).
"""
from __future__ import annotations

import argparse
import glob

import numpy as np
import torch


def iterate_batches(shard_paths, batch_size, seed=0):
    """Endless (images, labels) batches: shards in a shuffled order,
    images of each shard in a shuffled order, the last partial batch of a
    shard dropped; the same numpy RNG sequence as the JAX package's."""
    rng = np.random.default_rng(seed)
    order = list(shard_paths)
    while True:
        rng.shuffle(order)
        for path in order:
            with np.load(path) as d:
                images, labels = d['images'], d['labels']
            idx = rng.permutation(images.shape[0])
            for i in range(0, len(idx) - batch_size + 1, batch_size):
                sel = idx[i:i + batch_size]
                yield images[sel], labels[sel]


def run(data_glob: str, steps: int = 1000, batch_size: int = 8,
        lr: float = 1e-3, ckpt_dir: str = 'semseg_ckpt',
        ckpt_every: int = 500, dp: int = None, seed: int = 0,
        stage_sizes=None, log_every: int = 50, *, device='cuda'):
    """Train for ``steps`` steps on ``device`` (the card unless the
    caller passes 'cpu'). ``batch_size`` is the global batch. ``dp`` is
    the data-parallel width; the rest of the ranks go to tensor
    parallelism. None (or 0) takes the JAX runner's default: the world
    when it is odd, else half of it, so 2 ranks train on (1, 2) and 4 on
    (2, 2). ValueError when dp does not divide the world. Returns (state,
    losses), the global losses on every rank."""
    import torch.distributed as dist

    from pc_accumulation_lib_tpu_torch.models import checkpoint as ckpt
    from pc_accumulation_lib_tpu_torch.models import train as train_mod
    from pc_accumulation_lib_tpu_torch.parallel import mesh as pmesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    dp = dp or (world if world % 2 else world // 2)
    if dp > world:
        raise ValueError(f'dp={dp} exceeds the {world} ranks')
    if world % dp:
        raise ValueError(f'dp={dp} does not divide the {world} ranks')
    mesh = None
    if dist.is_initialized():
        mesh = pmesh.make_mesh((dp, world // dp), ('data', 'model'),
                               torch.device(device).type)
    shards = sorted(glob.glob(data_glob))
    if not shards:
        raise FileNotFoundError(f'no training shards match {data_glob!r}')
    with np.load(shards[0]) as d:
        hw = d['images'].shape[1:3]
    state, train_step = train_mod.make_train_setup(
        lr=lr, img_hw=tuple(hw), seed=seed, stage_sizes=stage_sizes,
        device=device, mesh=mesh)

    it = iterate_batches(shards, batch_size, seed)
    losses = []
    for step_i in range(1, steps + 1):
        images, labels = next(it)
        # uint8 and the label dtype over the link; float on the device.
        images = torch.from_numpy(images).to(device).to(torch.float32)
        labels = torch.from_numpy(labels).to(device)
        state, loss = train_step(state, images, labels)
        losses.append(float(loss))
        if step_i % log_every == 0:
            print(f'step {step_i} | loss {np.mean(losses[-log_every:]):.4f}')
        if ckpt_every and step_i % ckpt_every == 0:
            ckpt.save_train_state(ckpt_dir, step_i, state)
    if ckpt_every and steps % ckpt_every:
        ckpt.save_train_state(ckpt_dir, steps, state)
    return state, losses


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('data_glob', type=str,
                        help="e.g. 'semseg_data/*.npz'")
    parser.add_argument('--steps', type=int, default=1000)
    parser.add_argument('--batch_size', type=int, default=8)
    parser.add_argument('--lr', type=float, default=1e-3)
    parser.add_argument('--ckpt_dir', type=str, default='semseg_ckpt')
    parser.add_argument('--ckpt_every', type=int, default=500)
    parser.add_argument('--dp', type=int, default=None,
                        help='data-parallel axis size (rest goes to TP; '
                        'default: the world when odd, else half of it)')
    parser.add_argument('--device', type=str, default='cuda')
    parser.add_argument('--coordinator_address', type=str, default=None)
    parser.add_argument('--num_processes', type=int, default=None)
    parser.add_argument('--process_id', type=int, default=None)
    args = parser.parse_args(argv)
    import torch.distributed as dist

    from pc_accumulation_lib_tpu_torch.parallel.mesh import (
        initialize_multihost)
    # A group of CPU tensors is gloo's, even where a card is visible.
    initialize_multihost(args.coordinator_address, args.num_processes,
                         args.process_id,
                         backend=('gloo' if torch.device(args.device).type
                                  == 'cpu' else None))
    run(args.data_glob, args.steps, args.batch_size, args.lr,
        args.ckpt_dir, args.ckpt_every, args.dp, device=args.device)
    # Only after success: a rank that raises exits at once and its
    # launcher ends the others (destroying an NCCL group while peers wait
    # in a collective can block).
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == '__main__':
    main()
