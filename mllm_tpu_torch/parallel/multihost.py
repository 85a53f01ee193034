"""Multi-host scale-out helpers over `torch.distributed`: counterpart of
`mllm_tpu/parallel/multihost.py`.

One process per rank (one GPU each on the card). Two tiers of interconnect:
NVLink inside a host, where tensor, pipeline and sequence parallelism belong,
and the network between hosts, fit only for data parallelism (one gradient
all-reduce a step). `initialize` joins the process group, `hybrid_mesh` lays
the between-host axes first so each within-host axis stays inside a host,
and `host_local_batch` / `process_batch_slice` give each rank its rows of the
global batch (the rank's tensor is its shard: there is no global array).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from . import comm


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None) -> None:
    """Join the process group. With coordinator_address ("host:port") the
    three arguments are explicit (init_method tcp://); without it they come
    from the environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, as
    torchrun sets them). backend: "nccl" (the card: each process takes GPU
    LOCAL_RANK, or its rank modulo the host's GPUs) or "gloo" (the CPU);
    None is NCCL, and raises without a card."""
    if backend is None:
        from ..utils.runtime import default_device

        default_device()
        backend = "nccl"
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("initialize: coordinator_address needs num_processes and process_id")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    else:
        dist.init_process_group(backend, init_method="env://")
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        torch.cuda.set_device(local)


def hybrid_mesh(ici: dict, dcn: Optional[dict] = None, device=None):
    """A `DeviceMesh` whose between-host axes (`dcn`, e.g. {"dp": 2}) lead
    and within-host axes (`ici`, e.g. {"tp": 4}) trail, over ranks
    0..prod-1 in rank order. With ranks numbered host by host (torchrun's
    order), each trailing axis then stays inside a host, and only the
    leading axes' collectives cross hosts. Raises ValueError when the world
    has fewer ranks than the mesh needs."""
    from torch.distributed.device_mesh import DeviceMesh

    from ..utils.runtime import default_device

    dcn = dcn or {}
    shape = tuple(dcn.values()) + tuple(ici.values())
    names = tuple(dcn) + tuple(ici)
    need = int(np.prod(shape)) if shape else 1
    if need > dist.get_world_size():
        raise ValueError(f"mesh needs {need} ranks, have {dist.get_world_size()}")
    dev = torch.device(device) if device is not None else default_device()
    comm.check_world(need, dev)
    return DeviceMesh(dev.type, torch.arange(need).reshape(shape), mesh_dim_names=names)


def process_batch_slice(n_global: int, axis_size: Optional[int] = None, *, mesh=None,
                        axis: str = "dp") -> slice:
    """Rows of the global batch this rank loads: with `mesh`, its index along
    `axis` (every rank of a tp group loads the same rows); otherwise its
    rank among the world's processes (the JAX contract). The batch must
    divide evenly. axis_size is unused, as in the JAX function."""
    if mesh is not None:
        pc, pi = comm.axis_size(mesh, axis), comm.axis_rank(mesh, axis)
    else:
        pc = dist.get_world_size() if dist.is_initialized() else 1
        pi = dist.get_rank() if dist.is_initialized() else 0
    if n_global % pc:
        raise ValueError(f"global batch {n_global} not divisible by {pc} processes")
    per = n_global // pc
    return slice(pi * per, (pi + 1) * per)


def host_local_batch(local_batch, mesh, axis: str = "dp") -> torch.Tensor:
    """This rank's rows (what it loaded with `process_batch_slice`) as its
    shard of the global batch along `axis`, on the mesh's device: the
    distributed loader's scatter. Checks that every rank along the axis holds
    as many rows."""
    x = torch.as_tensor(np.asarray(local_batch)).to(comm.mesh_device(mesh))
    n = comm.axis_size(mesh, axis)
    if n > 1:
        rows = torch.tensor([x.shape[0]], device=x.device)
        seen = [torch.empty_like(rows) for _ in range(n)]
        dist.all_gather(seen, rows, group=comm.axis_group(mesh, axis))
        if len({int(t) for t in seen}) != 1:
            raise ValueError(f"host_local_batch: ranks hold {[int(t) for t in seen]} rows along {axis}")
    return x
