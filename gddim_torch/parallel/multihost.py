"""The process group and its helpers (counterpart of
``gddim_tpu/parallel/multihost.py``).

The JAX package joins hosts with ``jax.distributed.initialize`` and
coordinates them with collectives over DCN; the port joins processes, one a
card, with ``torch.distributed.init_process_group`` over TCP. Backend
``nccl`` on CUDA, ``gloo`` on the CPU or where the caller asks for it (two
ranks sharing one card: NCCL refuses a GPU twice, gloo stages CUDA tensors
through the host). Every helper is plain at one process, where no group
exists.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def initialize_distributed(coordinator: str | None = None, num_processes: int | None = None,
                           process_id: int | None = None, backend: str | None = None,
                           device: str = "cuda") -> bool:
    """Join the process group at ``tcp://{coordinator}`` (host:port) as rank
    ``process_id`` of ``num_processes``. A no-op at one process unless a
    coordinator is given (then a group of one, to run the parallel paths
    alone). ``backend``: 'nccl' or 'gloo'; by default nccl where ``device``
    is CUDA, else gloo. On CUDA each process takes card
    ``process_id % device_count``. Returns whether a group was made."""
    n = int(num_processes or 1)
    if n <= 1 and not coordinator:
        return False
    if not coordinator:
        raise ValueError(f"{n} processes need a coordinator address (host:port)")
    rank = int(process_id or 0)
    cuda = str(device).startswith("cuda")
    backend = backend or ("nccl" if cuda else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
    kwargs = {}
    if cuda:
        torch.cuda.set_device(rank % torch.cuda.device_count())
        if backend == "nccl":
            kwargs["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}", world_size=n, rank=rank,
                            **kwargs)
    return True


def shutdown() -> None:
    """Leave the process group, if there is one."""
    if is_distributed():
        dist.destroy_process_group()


def is_distributed() -> bool:
    """Whether this process is in a process group."""
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if is_distributed() else 1


def process_index() -> int:
    return dist.get_rank() if is_distributed() else 0


def is_coordinator() -> bool:
    return process_index() == 0


def local_device(device="cuda") -> torch.device:
    """``device`` as this process uses it: 'cuda' is this rank's card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and is_distributed():
        return torch.device("cuda", torch.cuda.current_device())
    return device


def comm_device() -> torch.device:
    """Where the group's collectives take their tensors: this rank's card
    under nccl, the host under gloo."""
    if is_distributed() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier(name: str = "sync") -> None:
    """Block until every rank arrives (``name`` says which barrier in a
    trace); plain at one process."""
    if process_count() == 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def allgather_metrics(local: dict) -> dict:
    """The mean over ranks of a dict of scalars (f32, as the JAX helper);
    every rank passes the same keys. The identity at one process."""
    if process_count() == 1:
        return dict(local)
    keys = sorted(local)
    vec = torch.tensor([float(local[k]) for k in keys], dtype=torch.float32,
                       device=comm_device())
    out = torch.empty(process_count() * len(keys), dtype=torch.float32, device=vec.device)
    dist.all_gather_into_tensor(out, vec)
    mean = out.view(process_count(), len(keys)).cpu().numpy().mean(axis=0, dtype=np.float32)
    return {k: float(v) for k, v in zip(keys, mean)}
