"""Data parallelism over processes with torch.distributed (the port's
counterpart of nsfnet_tpu/parallel/mesh.py).

The reference's only parallelism is data parallelism: collocation /
boundary / supervised points sliced per rank with DDP's gradient all-reduce
over NCCL (ev-NSFnet/pinn_solver.py:142-184, 102-106; train.py:22-43). The
JAX package does it with a 1-D 'data' mesh; the port does it PyTorch's way:
one process per card (`torchrun --nproc_per_node=N`), a process group with
NCCL on cards and gloo on the CPU, and each rank holding a contiguous block
of every padded point set, in the row order of JAX's
NamedSharding(P('data', None)). Parameters and optimizer state are
replicated: every rank starts from the same seed and applies the same
all-reduced gradient.

Point batches are padded with zero-weight rows to a multiple of
world x a row granule, so every rank's block (and every microbatch slice of
it) is whole kernel tiles; masks and real-point counts keep every loss an
exact mean over the real points.
"""

from __future__ import annotations

import math
import os
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

# Environment markers meaning "this process is one of N > 1 of a launched
# job": torchrun's count, the JAX package's launcher count, and the
# schedulers (SLURM / Open MPI / PMI).
_WORLD_SIZE_VARS = ("WORLD_SIZE", "NSFNET_NUM_PROCESSES", "SLURM_NTASKS",
                    "OMPI_COMM_WORLD_SIZE", "PMI_SIZE")
_RANK_VARS = ("RANK", "SLURM_PROCID", "OMPI_COMM_WORLD_RANK", "PMI_RANK")
_LOCAL_RANK_VARS = ("LOCAL_RANK", "SLURM_LOCALID", "OMPI_COMM_WORLD_LOCAL_RANK",
                    "MPI_LOCALRANKID")


def _first_int(env: Mapping, names) -> Optional[int]:
    for var in names:
        try:
            return int(env[var])
        except (KeyError, TypeError, ValueError):
            continue  # unset or malformed: try the next marker
    return None


def should_initialize_distributed(environ: Optional[Mapping] = None) -> bool:
    """Decide from the environment ALONE whether this process belongs to a
    launched job (nsfnet_tpu/parallel/mesh.py:36-53): a world size above 1
    under any launcher, or torchrun's own markers, which ask for a process
    group even at one process (`--nproc_per_node=1`)."""
    env = os.environ if environ is None else environ
    if env.get("TORCHELASTIC_RUN_ID") or (env.get("MASTER_ADDR") and "WORLD_SIZE" in env):
        return True
    for var in _WORLD_SIZE_VARS:
        try:
            if int(env.get(var, "1")) > 1:
                return True
        except (TypeError, ValueError):
            continue  # malformed count: ignore this marker
    return False


def initialize_distributed(device_type: str, environ: Optional[Mapping] = None,
                           backend: Optional[str] = None) -> Tuple[int, int, int]:
    """Join the launched job's process group (replaces torchrun's rendezvous
    in ev-NSFnet/train.py:22-43, and jax.distributed in the JAX package):
    `nccl` for cuda, `gloo` for the CPU, unless `backend` names one. On cuda
    the process takes the card `LOCAL_RANK`. Returns (rank, world_size,
    local_rank); (0, 1, 0) and no group for a single-process launch.

    The rendezvous is `env://`: MASTER_ADDR and MASTER_PORT of the process's
    environment, which torchrun sets (a scheduler's job script exports
    them), and the rank and world size from torchrun's or the scheduler's
    variables. A detected launch whose bring-up fails RAISES
    (nsfnet_tpu/parallel/mesh.py:56-74): degrading to one process would
    train on 1/N of the data without saying so."""
    env = os.environ if environ is None else environ
    if not should_initialize_distributed(env):
        return 0, 1, 0
    import torch.distributed as dist

    from nsfnet_tpu_torch.logger import get_logger

    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    world = _first_int(env, _WORLD_SIZE_VARS)
    rank = _first_int(env, _RANK_VARS)
    local_rank = _first_int(env, _LOCAL_RANK_VARS)
    if dist.is_initialized():  # joined already (a caller that brought it up first)
        rank, world = dist.get_rank(), dist.get_world_size()
        return rank, world, rank if local_rank is None else local_rank
    try:
        if world is None or rank is None:
            raise RuntimeError(f"a launch was detected but its rank / world size could not "
                               f"be read (one of {_RANK_VARS} and of {_WORLD_SIZE_VARS})")
        local_rank = rank if local_rank is None else local_rank
        if device_type == "cuda":
            torch.cuda.set_device(local_rank)
        addr, port = env.get("MASTER_ADDR"), env.get("MASTER_PORT")
        if not addr or not port:
            raise RuntimeError("a launch was detected but MASTER_ADDR / MASTER_PORT are not "
                               "set (torchrun sets them; a scheduler's job script exports them)")
        # env:// (not tcp://): under torchrun the agent already serves the
        # store at MASTER_PORT, and env:// joins it as a client
        dist.init_process_group(
            backend=backend, init_method="env://", rank=rank, world_size=world,
            device_id=torch.device("cuda", local_rank) if backend == "nccl" else None)
    except Exception:
        get_logger().error("multi-process launch detected (world-size / torchrun "
                           "environment set) but torch.distributed could not be brought "
                           "up; refusing to fall back to single-process training")
        raise
    return rank, world, local_rank


def process_group():
    """The default process group where one is initialized, else None (a
    single-process run: no collective anywhere)."""
    import torch.distributed as dist

    return dist.group.WORLD if dist.is_available() and dist.is_initialized() else None


def rank_and_world(group) -> Tuple[int, int]:
    """(this process's rank, the group's size); (0, 1) for no group."""
    if group is None:
        return 0, 1
    import torch.distributed as dist

    return dist.get_rank(group), dist.get_world_size(group)


def padded_size(n: int, mesh_size: int, lane: int = 8) -> int:
    """Pad row counts to a multiple of mesh_size*lane."""
    m = mesh_size * lane
    return int(math.ceil(max(n, 1) / m) * m)


def pad_rows(arr: np.ndarray, target_rows: int, fill: float = 0.0) -> np.ndarray:
    """Pad a [N, ...] array with `fill` rows up to target_rows."""
    n = arr.shape[0]
    if n == target_rows:
        return arr
    pad_shape = (target_rows - n,) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, fill, dtype=arr.dtype)], axis=0)


def shard_rows(a, rank: int, world: int):
    """Rank `rank`'s contiguous block of the rows of a padded array or
    tensor (rows divisible by world), as P('data', None) places them."""
    n = a.shape[0]
    if n % world:
        raise ValueError(f"{n} rows do not split over {world} ranks; pad them first")
    m = n // world
    return a[rank * m:(rank + 1) * m]


def all_reduce_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum `t` over the ranks of `group`, in place; returns it."""
    import torch.distributed as dist

    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's rows of a row-sharded tensor (equal blocks),
    concatenated in rank order, on every rank."""
    import torch.distributed as dist

    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)
