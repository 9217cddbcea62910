r"""
:mod:`parallel.distributed` -- Multi-process campaigns
======================================================

Counterpart of ``xcorr_tpu/parallel/distributed.py`` (SURVEY.md §2.8 P5:
the reference forms a Dask cluster from a scheduler file,
``xcorr/scripts/utils.py:50-79``). Processes, one per host or per card,
join one ``torch.distributed`` group and each takes its contiguous
:func:`host_slice` of the (pair x day) grid and writes its own shards: the
filesystem stays the data plane and no tensor crosses the group.

The group uses the ``gloo`` backend: it runs on the CPU, and it takes
several ranks on one card, which NCCL refuses.
"""

from __future__ import annotations

import datetime
import os

import numpy as np

__all__ = ["initialize", "host_slice", "shutdown"]

#: seconds that the group's formation, and every collective, may take
_FORMATION_TIMEOUT_S = 300


def _env_address():
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    return f"{addr}:{port}" if addr and port else None


def _env_int(name):
    v = os.environ.get(name)
    return None if v is None else int(v)


def initialize(coordinator_address: str = None, num_processes: int = None,
               process_id: int = None) -> bool:
    """Join the process group at ``coordinator_address`` (``host:port``,
    where process 0 listens); returns False (no-op) when there is no
    coordinator.

    Without an address, the group forms from the variables ``torchrun``
    sets (``env://``): ``MASTER_ADDR`` and ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``, which also give ``num_processes`` and ``process_id`` when
    they are not passed. The formation and every collective may take
    :data:`_FORMATION_TIMEOUT_S`. Joining again with the same rank and
    size is a no-op.
    """
    import torch.distributed as dist
    env = _env_address()
    if coordinator_address is None and env is None:
        if num_processes is None:
            return False  # single process
        raise ValueError("num_processes given without a coordinator "
                         "address (or MASTER_ADDR/MASTER_PORT)")
    n = num_processes if num_processes is not None \
        else _env_int("WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("RANK")
    if n is None or rank is None:
        raise ValueError("num_processes and process_id are needed (or "
                         "WORLD_SIZE and RANK)")
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (n, rank):
            raise RuntimeError(
                f"already in a group as rank {dist.get_rank()} of "
                f"{dist.get_world_size()}, not {rank} of {n}")
        return True
    init = "env://" if coordinator_address is None else \
        "tcp://" + coordinator_address.removeprefix("tcp://")
    dist.init_process_group(
        "gloo", init_method=init, world_size=int(n), rank=int(rank),
        timeout=datetime.timedelta(seconds=_FORMATION_TIMEOUT_S))
    return True


def _group():
    """``(rank, world size)`` of the group, ``(0, 1)`` outside one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_slice(items, process_id: int = None, num_processes: int = None):
    """This process's contiguous share of a work-item list (the rank and
    world size of the group by default)."""
    rank, size = _group()
    pid = process_id if process_id is not None else rank
    n = num_processes if num_processes is not None else size
    bounds = np.linspace(0, len(items), n + 1).astype(int)
    return list(items)[bounds[pid]: bounds[pid + 1]]


def shutdown():
    """Leave the group (no-op outside one)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
