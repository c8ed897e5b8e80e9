"""The process group of a data-parallel run.

PyTorch counterpart of ``commu_tpu/parallel/multihost.py``, over
``torch.distributed``:

- **Rendezvous.** ``initialize`` calls ``init_process_group`` on a TCP
  address: the reference's rendezvous with its address, world size and rank
  passed explicitly (nothing on the machine announces a cluster).  NCCL for
  CUDA devices, gloo for the CPU, unless the caller names a backend.
- **Data feed.** Every process runs the same deterministic packing
  iterator (same seed) and keeps its own contiguous rows of the global
  batch (``process_batch_slice``), as the JAX package does.
- **Writes.** Checkpoints, the config snapshot and the console log are rank
  0's (``is_primary``), bracketed by ``sync`` barriers.

Without a process group every function answers for one process: count 1,
index 0, primary, ``sync`` a no-op.
"""
from __future__ import annotations

import datetime
from typing import Optional

import torch
import torch.distributed as dist


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, backend: Optional[str] = None,
               device=None) -> None:
    """Join the process group at ``coordinator_address`` (``host:port`` of
    process 0, or a ``tcp://`` URL) as rank ``process_id`` of
    ``num_processes``.  ``backend``: "nccl" or "gloo"; by default NCCL when
    ``device`` is a CUDA device, gloo otherwise.  A CUDA ``device`` becomes
    the process's current device first."""
    if not coordinator_address or num_processes is None or \
            process_id is None:
        raise ValueError("a process group needs the coordinator's address, "
                         "the number of processes and this process's id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside "
                         f"[0, {num_processes})")
    device = torch.device(device) if device is not None else None
    if device is not None and device.type == "cuda":
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device is not None and device.type == "cuda" \
            else "gloo"
    address = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=address,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(minutes=10))


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def shutdown() -> None:
    """Leave the process group, if there is one."""
    if is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_primary() -> bool:
    """True on the process that owns checkpoints and logs (rank 0)."""
    return process_index() == 0


def sync(name: str = "commu_sync") -> None:
    """A barrier of every process (the reference's ``dist.barrier()``); a
    no-op for one process.  ``name`` only labels the call site."""
    del name
    if process_count() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def process_batch_slice(global_batch: int,
                        pindex: Optional[int] = None,
                        pcount: Optional[int] = None) -> slice:
    """Contiguous per-process row slice of the global batch.

    The packing iterator is deterministic given its seed, so every process
    materializes the identical global batch on host and keeps only its rows —
    same statistics as the reference's per-rank iterators (dataset.py:196-205)
    without per-rank seed skew."""
    pindex = process_index() if pindex is None else pindex
    pcount = process_count() if pcount is None else pcount
    if global_batch % pcount != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by {pcount} processes")
    rows = global_batch // pcount
    return slice(pindex * rows, (pindex + 1) * rows)


def broadcast_string(text: str) -> str:
    """Process 0's ``text`` on every process (the run's work-dir timestamp:
    the reference broadcasts its ``exp_time``)."""
    if process_count() == 1:
        return text
    box = [text]
    dist.broadcast_object_list(box, src=0)
    return box[0]
