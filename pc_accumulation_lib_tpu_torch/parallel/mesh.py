"""Device mesh and collectives on torch.distributed.

Counterpart of parallel/mesh.py. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the JAX package's axis
names (('data', 'points') for rasters, ('data', 'model') for training,
('pp',) for the pipeline) over the default process group; each named axis
has its own process group (``mesh.get_group(axis)``). The functions below
are the port's counterparts of jax.lax.psum / pmin / pmax / all_to_all /
all_gather / ppermute over one named axis, and every engine of the port
calls them, so the choice of backend is the caller's.

On a gloo group a CUDA tensor goes through host memory: gloo's support of
CUDA tensors differs by collective and by build (point-to-point sends
read the pointer as host memory), and where it has it, it stages the
tensor through host memory itself. The choice is made from the group's
backend, never by catching a failure; NCCL groups take CUDA tensors as
they are.
"""
from __future__ import annotations

import datetime
from typing import Optional, Sequence

import torch
import torch.distributed as dist

# Collective timeout of the process groups this module creates: a rank
# that dies or hangs fails its peers' next collective instead of blocking
# them for torch's default of 30 minutes.
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=300)


def make_mesh(axis_sizes: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ('data', 'points'),
              device_type: str = 'cuda'):
    """A DeviceMesh of ``axis_sizes`` named ``axis_names`` over the
    default process group (initialized by the caller, e.g. by
    initialize_multihost). Default: every rank on the last axis, (1,
    world) for ('data', 'points'). ``device_type`` is 'cuda' unless the
    caller asks for the CPU."""
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = (1,) * (len(axis_names) - 1) + (world,)
    axis_sizes = tuple(int(s) for s in axis_sizes)
    n = 1
    for s in axis_sizes:
        n *= s
    if n != world:
        raise ValueError(f'axis sizes {axis_sizes} != {world} ranks')
    return init_device_mesh(device_type, axis_sizes,
                            mesh_dim_names=tuple(axis_names))


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None,
                         timeout: datetime.timedelta = COLLECTIVE_TIMEOUT
                         ) -> None:
    """Join the default process group: ``coordinator_address`` is
    'host:port' (taken as tcp://host:port) or an init-method URL
    ('tcp://...', 'file://...'). A no-op when it is None (one process, no
    mesh). The backend is NCCL when the card is there and gloo otherwise,
    unless the caller names one; with NCCL each process takes card
    ``process_id % device_count``."""
    if coordinator_address is None:
        return
    if backend is None:
        backend = 'nccl' if torch.cuda.is_available() else 'gloo'
    url = (coordinator_address if '://' in coordinator_address
           else f'tcp://{coordinator_address}')
    if backend == 'nccl':
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id,
                            timeout=timeout)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    """This rank's index along ``axis``."""
    return mesh.get_local_rank(axis)


def _staged(group, x: torch.Tensor) -> bool:
    return x.is_cuda and dist.get_backend(group) == 'gloo'


def _all_reduce(x, mesh, axis, op):
    group = mesh.get_group(axis)
    if _staged(group, x):
        h = x.cpu()
        dist.all_reduce(h, op=op, group=group)
        return h.to(x.device)
    y = x.clone()
    dist.all_reduce(y, op=op, group=group)
    return y


def psum(x, mesh, axis: str):
    """Sum of ``x`` over the ranks of ``axis`` (jax.lax.psum)."""
    return _all_reduce(x, mesh, axis, dist.ReduceOp.SUM)


def pmin(x, mesh, axis: str):
    return _all_reduce(x, mesh, axis, dist.ReduceOp.MIN)


def pmax(x, mesh, axis: str):
    return _all_reduce(x, mesh, axis, dist.ReduceOp.MAX)


def all_to_all(x, mesh, axis: str):
    """Block d of ``x`` (dim 0 cut into axis-size equal blocks) goes to
    rank d; block s of the result came from rank s (jax.lax.all_to_all,
    tiled, split and concat on dim 0)."""
    group = mesh.get_group(axis)
    src = x.contiguous()
    if _staged(group, x):
        h = src.cpu()
        out = torch.empty_like(h)
        dist.all_to_all_single(out, h, group=group)
        return out.to(x.device)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out


def all_gather(x, mesh, axis: str):
    """(axis size, *x.shape): row r is rank r's ``x``."""
    group = mesh.get_group(axis)
    n = axis_size(mesh, axis)
    src = x.reshape(-1)
    if _staged(group, x):
        src = src.cpu()
    out = src.new_empty(n * src.numel())
    dist.all_gather_into_tensor(out, src, group=group)
    return out.view((n,) + tuple(x.shape)).to(x.device)


def broadcast(x, mesh, axis: str, src: int = 0):
    """``x`` of rank ``src`` (its index along ``axis``) on every rank of
    the axis; ``x`` is overwritten in place on the others and returned."""
    group = mesh.get_group(axis)
    root = dist.get_global_rank(group, src)
    if _staged(group, x):
        h = x.cpu()
        dist.broadcast(h, src=root, group=group)
        x.copy_(h)
        return x
    dist.broadcast(x, src=root, group=group)
    return x


def broadcast_object(obj, mesh, axis: str, src: int = 0):
    """A picklable object of rank ``src`` on every rank of the axis."""
    group = mesh.get_group(axis)
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, src),
                               group=group)
    return box[0]


def scatter(x, out, mesh, axis: str, src: int = 0):
    """Rank ``src`` cuts ``x`` on dim 0 into axis-size equal blocks and
    rank r receives block r into ``out`` (jax.device_put onto P(axis));
    ``x`` is ignored on the other ranks. Returns ``out``."""
    group = mesh.get_group(axis)
    root = dist.get_global_rank(group, src)
    mine = axis_rank(mesh, axis) == src
    n = axis_size(mesh, axis)
    staged = _staged(group, out)
    recv = out.cpu() if staged else out
    blocks = None
    if mine:
        full = x.cpu() if staged else x
        blocks = [b.contiguous() for b in full.chunk(n, dim=0)]
    dist.scatter(recv, blocks, src=root, group=group)
    if staged:
        out.copy_(recv)
    return out


def _ring(x, mesh, axis, shift):
    """y on rank r = x of rank (r - shift) mod n (one send, one receive
    per rank)."""
    group = mesh.get_group(axis)
    n = axis_size(mesh, axis)
    r = axis_rank(mesh, axis)
    if n == 1:
        return x.clone()
    staged = _staged(group, x)
    src = (x.cpu() if staged else x).contiguous()
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src,
                      dist.get_global_rank(group, (r + shift) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (r - shift) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(x.device) if staged else out


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return _ring(x, mesh, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return _ring(g, ctx.mesh, ctx.axis, -ctx.shift), None, None, None


def ppermute(x, mesh, axis: str, shift: int = 1):
    """Ring shift along ``axis``: rank r gets rank (r - shift)'s ``x``
    (jax.lax.ppermute with perm [(i, i + shift)]); its gradient takes the
    reverse ring."""
    return _Ppermute.apply(x, mesh, axis, shift)


class _PsumPerRankLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return psum(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.mesh, ctx.axis), None, None


def psum_per_rank_loss(x, mesh, axis: str):
    """psum whose gradient is the psum of the ranks' gradients: for a
    result that feeds a different loss term on each rank, the terms
    summing to the loss (data-parallel batch statistics)."""
    return _PsumPerRankLoss.apply(x, mesh, axis)


class _PsumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return psum(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def psum_replicated(x, mesh, axis: str):
    """psum into a replicated result: every rank computes the same loss
    from it and that loss counts once, so each rank's input gets the
    result's gradient as it is (JAX's psum into an axis-invariant value
    under shard_map)."""
    return _PsumReplicated.apply(x, mesh, axis)


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.rank, ctx.width = axis_rank(mesh, axis), x.shape[1]
        rows = all_gather(x, mesh, axis)             # (n, B, c, ...)
        return rows.movedim(0, 1).flatten(1, 2)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.rank * ctx.width
        return g[:, lo:lo + ctx.width].contiguous(), None, None


def gather_channels(x, mesh, axis: str):
    """The ranks' channel slices (dim 1) of ``x`` concatenated in rank
    order into the full tensor; the gradient of rank r's slice is slice r
    of the result's gradient, with no reduction. A layer whose output
    channels are sharded over ``axis`` hands its slice on through this
    before a consumer that reads every channel (the all-gather of
    Megatron's tensor parallelism)."""
    return _GatherChannels.apply(x, mesh, axis)


class _CopyToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.mesh, ctx.axis), None, None


def copy_to_axis(x, mesh, axis: str):
    """The identity, whose gradient is the psum of the ranks' gradients:
    the input, the same on every rank of ``axis``, of a layer whose
    output channels are sharded over it, so that each rank's gradient of
    the input is its slice's contribution (Megatron's f, the partner of
    gather_channels)."""
    return _CopyToAxis.apply(x, mesh, axis)
