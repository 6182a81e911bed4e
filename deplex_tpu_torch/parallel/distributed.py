"""Multi-process initialization, device meshes and the collectives.

Port of ``deplex_tpu.parallel.distributed`` over ``torch.distributed``.
``initialize()`` joins the process group that ``parallel.launcher`` (or
torchrun, or a scheduler) describes through the env contract

    MASTER_ADDR, MASTER_PORT   process 0's rendezvous endpoint
    WORLD_SIZE, RANK           group size and this process's rank
    LOCAL_RANK                 this process's index on its host
    DEPLEX_DEVICE              optional: cuda or cpu (default cuda)
    DEPLEX_BACKEND             optional: nccl or gloo (default by device)

and ``make_mesh``/``make_slam_mesh`` name the axes the rest of the package
shards over, as in the reference: 'data' (the frame batch: extraction needs
no collective) and 'kf' (the keyframes of bundle adjustment, whose Schur
blocks are summed and gathered across ranks).

The backend is what the caller says, never switched behind its back:
NCCL for CUDA ranks and gloo for CPU ranks unless told otherwise, and a
failed ``init_process_group`` raises. gloo on CUDA tensors supports only a
few collectives, so ``all_reduce_sum`` and ``all_gather_cat`` stage CUDA
tensors through host copies under gloo (two ranks sharing one card must use
gloo: NCCL refuses two ranks on one device); under NCCL they pass through.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from deplex_tpu_torch.pipeline import resolve_device

BACKENDS = ("nccl", "gloo")
# How long a rank waits for the others, at the rendezvous and in a collective.
RENDEZVOUS_TIMEOUT_S = 300


def initialize(backend: str | None = None) -> torch.device | None:
    """Join the process group of the env contract; returns this rank's
    device, or None (and does nothing) when the contract is absent, so one
    script runs from one process to many.

    The device is $DEPLEX_DEVICE ('cuda' or 'cpu'), else the card, which
    must exist. A CUDA rank takes card LOCAL_RANK % device_count and makes
    it current before anything launches. backend: 'nccl' or 'gloo'
    (default: $DEPLEX_BACKEND, else nccl for CUDA, gloo for CPU)."""
    env = os.environ
    if "WORLD_SIZE" not in env or "MASTER_ADDR" not in env:
        return None
    world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
    local_rank = int(env.get("LOCAL_RANK", rank))
    dev = resolve_device(env.get("DEPLEX_DEVICE") or None)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        torch.cuda.init()
    backend = backend or env.get("DEPLEX_BACKEND") or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs CUDA ranks")
    if not dist.is_initialized():
        dist.init_process_group(backend=backend,
                                init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=RENDEZVOUS_TIMEOUT_S))
    return dev


def world_size() -> int:
    """Ranks of the initialized default group; 1 when there is none."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _mesh_device_type() -> str:
    """The mesh's device type: the backend's (gloo meshes are CPU meshes,
    whatever device their ranks compute on)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(axis: str = "data") -> DeviceMesh:
    """1-D mesh over every rank of the initialized world."""
    return init_device_mesh(_mesh_device_type(), (dist.get_world_size(),),
                            mesh_dim_names=(axis,))


def make_slam_mesh(kf_parallel: int | None = None) -> DeviceMesh:
    """2-D mesh ('data', 'kf'): frames over 'data', the keyframes of bundle
    adjustment over 'kf' (default: the largest power of two dividing the
    world)."""
    n = dist.get_world_size()
    if kf_parallel is None:
        kf_parallel = 1
        while n % (kf_parallel * 2) == 0:
            kf_parallel *= 2
    if n % kf_parallel:
        raise ValueError(f"{n} ranks not divisible by kf_parallel={kf_parallel}")
    return init_device_mesh(_mesh_device_type(), (n // kf_parallel, kf_parallel),
                            mesh_dim_names=("data", "kf"))


def local_batch_slice(global_batch: int, mesh: DeviceMesh, axis: str = "data"):
    """(start, size) of this rank's shard of the global frame batch."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if global_batch % n:
        raise ValueError(f"batch {global_batch} not divisible by {n}")
    per = global_batch // n
    return mesh.get_local_rank(axis) * per, per


def _staged(x: torch.Tensor, group) -> bool:
    return x.device.type != "cpu" and dist.get_backend(group) == "gloo"


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of x over the group's ranks, on x's device (x is not changed).
    Every rank gets the same bits."""
    y = x.detach().to("cpu", copy=True) if _staged(x, group) else x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y.to(x.device)


def all_gather_cat(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' x concatenated along dim 0, in group-rank order, on x's
    device."""
    src = (x.detach().cpu() if _staged(x, group) else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(x.device)
