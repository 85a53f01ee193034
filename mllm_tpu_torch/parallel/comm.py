"""Mesh axes and the collectives the parallel modules run, over
`torch.distributed`.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` with named dims
("dp", "tp", "pp", "ep", "sp", ...). Every rank holds plain local tensors and
calls the collectives itself: gloo for CPU tensors, NCCL for CUDA ones (the
backend of the process group the mesh was built over). Nothing here falls
back from one device to another.

The collectives that a gradient passes through are `torch.autograd.Function`s
with the backward written out:
  - `copy_to_axis`: identity forward, all-reduce backward (the entry of a
    column-parallel region: each rank's input gradient is a partial sum);
  - `reduce_from_axis`: all-reduce forward, identity backward (the exit of a
    row-parallel region: the sum is replicated, so each rank's gradient of
    it is the whole gradient already). `torch.distributed.nn.functional.
    all_reduce` all-reduces in its backward too, which on a replicated loss
    multiplies the gradients by the axis size;
  - `gather_from_axis`: all-gather along the last dim forward, the rank's
    slice backward (vocab-parallel logits);
  - `all_to_all_axis`: split one dim, concatenate another (Ulysses); its
    backward is the inverse exchange;
  - `ring_shift`: send to the next rank, receive from the previous one (ring
    attention, the pipeline); its backward sends the gradient the other way.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..utils.runtime import default_device


def _dim(mesh, axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r} (axes {names})")
    return names.index(axis)


def has_axis(mesh, axis: str) -> bool:
    return mesh is not None and axis in (mesh.mesh_dim_names or ())


def axis_size(mesh, axis: str) -> int:
    """Ranks along `axis` (1 when the mesh has no such axis, as JAX's
    `mesh.shape.get(axis, 1)`)."""
    return mesh.size(_dim(mesh, axis)) if has_axis(mesh, axis) else 1


def axis_rank(mesh, axis: str) -> int:
    """This rank's index along `axis` (0 when the mesh has no such axis)."""
    return mesh.get_local_rank(_dim(mesh, axis)) if has_axis(mesh, axis) else 0


def axis_group(mesh, axis: str):
    return mesh.get_group(_dim(mesh, axis))


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors live on for `mesh`."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def make_axis_mesh(axis: str, n: int, device=None):
    """A 1-D mesh named `axis` over ranks 0..n-1 of the initialised world.
    device: "cuda" or "cpu"; None is the card (raises without one)."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = torch.device(device) if device is not None else default_device()
    check_world(n, dev)
    return DeviceMesh(dev.type, list(range(n)), mesh_dim_names=(axis,))


def check_world(n: int, dev: torch.device) -> None:
    """Raise unless the process group is up with at least n ranks and, on the
    card, this host has a GPU for each of them."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: call parallel.multihost.initialize "
                           "(or torch.distributed.init_process_group) first")
    if dist.get_world_size() < n:
        raise ValueError(f"mesh needs {n} ranks, the world has {dist.get_world_size()}")
    if dev.type == "cuda" and torch.cuda.device_count() * hosts() < n:
        raise ValueError(f"mesh needs {n} GPUs, {hosts()} host(s) of {torch.cuda.device_count()} have "
                         f"{torch.cuda.device_count() * hosts()}")


def hosts() -> int:
    """Hosts in the world: world size over LOCAL_WORLD_SIZE (the ranks a host
    runs, as torchrun sets it; unset, every rank is on this host)."""
    import os

    world = dist.get_world_size()
    return max(1, world // int(os.environ.get("LOCAL_WORLD_SIZE", world)))


# ---------------------------------------------------------------------------
# Collectives with hand-written backwards
# ---------------------------------------------------------------------------


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


class _CopyToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _gather_last(x: torch.Tensor, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


class _GatherFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[-1]
        return _gather_last(x, group)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return g[..., r * ctx.n:(r + 1) * ctx.n].contiguous(), None


def _a2a(x: torch.Tensor, split: int, concat: int, group) -> torch.Tensor:
    """Split x into n chunks along `split`, send chunk j to rank j, and
    concatenate what arrives (rank order) along `concat`."""
    n = dist.get_world_size(group)
    send = torch.stack(torch.chunk(x, n, dim=split)).contiguous()  # [n, ...]
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(list(recv.unbind(0)), dim=concat)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split, concat, group):
        ctx.args = (split, concat, group)
        return _a2a(x, split, concat, group)

    @staticmethod
    def backward(ctx, g):
        split, concat, group = ctx.args
        return _a2a(g, concat, split, group), None, None, None


def _shift(x: torch.Tensor, step: int, group) -> torch.Tensor:
    """Send x to the rank `step` ahead on the ring, receive from the rank
    `step` behind."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    x = x.contiguous()
    if n == 1:
        return x.clone()
    out = torch.empty_like(x)
    to = dist.get_global_rank(group, (r + step) % n)
    frm = dist.get_global_rank(group, (r - step) % n)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, to, group),
                                   dist.P2POp(dist.irecv, out, frm, group)])
    for q in reqs:
        q.wait()
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, 1, group)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, -1, ctx.group), None


def copy_to_axis(x, mesh, axis: str):
    return _CopyToAxis.apply(x, axis_group(mesh, axis))


def reduce_from_axis(x, mesh, axis: str):
    return _ReduceFromAxis.apply(x, axis_group(mesh, axis))


def gather_from_axis(x, mesh, axis: str):
    return _GatherFromAxis.apply(x, axis_group(mesh, axis))


def all_to_all_axis(x, mesh, axis: str, split: int, concat: int):
    return _AllToAll.apply(x, split % x.dim(), concat % x.dim(), axis_group(mesh, axis))


def ring_shift(x, mesh, axis: str):
    return _RingShift.apply(x, axis_group(mesh, axis))


def all_reduce_(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """In-place sum over `axis`, outside autograd (gradients, statistics)."""
    dist.all_reduce(x, group=axis_group(mesh, axis))
    return x


def dp_mean(model, params, grads, loss):
    """(grads, loss) averaged over the dp axis of `model.mesh` (unchanged
    without a mesh or at dp 1): one flat f32 all-reduce. A None gradient
    enters as zeros."""
    mesh = getattr(model, "mesh", None)
    if mesh is None or axis_size(mesh, "dp") == 1:
        return grads, loss
    dp = axis_size(mesh, "dp")
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    flat = torch.cat([g.float().reshape(-1) for g in grads] + [loss.float().reshape(1)])
    all_reduce_(flat, mesh, "dp")
    flat /= dp
    parts = torch.split(flat[:-1], [g.numel() for g in grads])
    return [f.view_as(g).to(g.dtype) for f, g in zip(parts, grads)], flat[-1].to(loss.dtype)
