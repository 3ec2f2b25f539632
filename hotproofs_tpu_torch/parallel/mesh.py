"""Device meshes for the proving stack on torch.distributed (port of
hotproofs_tpu/parallel/mesh.py).

The reference's mesh is JAX's: one process holds many devices, and a
`Mesh` names their axes. The port follows torch's idiom instead: one
process a device, joined in a process group (NCCL on the card, gloo on the
CPU), and a `DeviceMesh` over the group's ranks names the same axes:

  * ``step``: independent per-step work (the W commits of a chunk's
    steps) split across devices;
  * ``msm``: one large MSM (a fold's comm_T) with its points split across
    devices, the partial sums gathered and added in rank order;
  * ``chain``: whole fold chains per device (prove_lockstep).

A multi-host run starts one process a device with HOTPROOFS_COORDINATOR,
HOTPROOFS_NUM_PROCESSES and HOTPROOFS_PROCESS_ID set, calls
init_distributed, then builds the mesh; segment proving splits chains
across processes with segments.prove_segments(my_segments=[rank::n]).
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..utils.config import require_device


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device="cuda") -> int:
    """Join this process to the group and return its rank.

    The arguments default to HOTPROOFS_COORDINATOR ("host:port", the rank-0
    store), HOTPROOFS_NUM_PROCESSES and HOTPROOFS_PROCESS_ID. A no-op
    returning 0 when neither arguments nor environment name a coordinator:
    one process needs no group. On "cuda" the process takes the card
    process_id modulo the cards it sees and joins with NCCL, started
    eagerly so a failure shows here; gloo is used only for "cpu"."""
    coordinator = coordinator or os.environ.get("HOTPROOFS_COORDINATOR")
    if coordinator is None:
        return 0
    num_processes = num_processes if num_processes is not None else \
        int(os.environ["HOTPROOFS_NUM_PROCESSES"])
    process_id = process_id if process_id is not None else \
        int(os.environ["HOTPROOFS_PROCESS_ID"])
    dev = require_device(device)
    kw = {}
    if dev.type == "cuda":
        local = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(local)
        backend, kw["device_id"] = "nccl", local
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"device {dev}: no process group backend")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id, **kw)
    return dist.get_rank()


def _device_mesh(device, shape: Tuple[int, ...], names: Tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh
    dev = require_device(device)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed first")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise AssertionError(
            f"mesh {'x'.join(map(str, shape))} != {world} devices")
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def make_mesh(step: int = 1, msm: Optional[int] = None, device="cuda"):
    """A (step, msm) DeviceMesh over the group's ranks, with the
    dimensions ("step", "msm"); msm defaults to the ranks left over."""
    if msm is None:
        msm = dist.get_world_size() // step if dist.is_initialized() else 1
    return _device_mesh(device, (step, msm), ("step", "msm"))


def make_chain_mesh(device="cuda"):
    """A 1-D DeviceMesh over all the group's ranks with the dimension
    "chain" (IVC.prove_lockstep(mesh=), chain per device)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    return _device_mesh(device, (n,), ("chain",))


def check_device(mesh, device: torch.device) -> None:
    """The mesh's collectives carry tensors of `device`'s type."""
    if mesh.device_type != torch.device(device).type:
        raise ValueError(f"a {mesh.device_type} mesh cannot carry "
                         f"{device} tensors")


def gather_points(pt, mesh, axis: str) -> torch.Tensor:
    """All-gather a rank's projective (J, 32) x3 int32 digits over the
    axis: (D, 3, J, 32), in rank order, on every rank."""
    mine = torch.stack(pt).contiguous()
    group = mesh.get_group(axis)
    out = [torch.empty_like(mine) for _ in range(group.size())]
    dist.all_gather(out, mine, group=group)
    return torch.stack(out)
