"""One rank per device, and the train step's reductions.

PyTorch counterpart of ``commu_tpu/parallel/mesh.py``.  The JAX package
drives a 1-D ``data`` mesh from one process and lets XLA insert the
gradient ``pmean``; here each device is a process of its own (a rank), the
batch is split by rows across the ranks (``multihost.process_batch_slice``),
parameters and optimizer state are replicated by construction (the same
seeded initialization and the same updates on every rank), and the
reductions are explicit collectives:

- ``reduce_gradients``: after every chunk's backward and before the clip,
  the mean of the gradients over the ranks and the sum of the step's metric
  sums, in ONE all-reduce of one flat bucket (``commu_tpu/training/
  step.py:399-406``: ``pmean`` of the gradients, ``psum`` of ``nll_sum`` and
  ``token_count``); the clip then sees the global gradient;
- ``sum_across``: the eval pass's sums.

``spawn`` starts the ranks of ``--num_devices N`` from one process
(``torch.multiprocessing``, rank r on ``cuda:r`` or on the CPU), each with
its own process group over a local TCP address.
"""
from __future__ import annotations

import socket

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from . import multihost


def check_device_count(num_devices: int, device) -> None:
    """Exit with a message when ``num_devices`` ranks would need more CUDA
    devices than the machine has: a rank never shares a device quietly.
    CPU ranks need none."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    available = torch.cuda.device_count()
    if num_devices > available:
        raise SystemExit(
            f"--num_devices {num_devices}: one rank a device needs "
            f"{num_devices} CUDA devices, and this machine has {available}")


def rank_device(device, rank: int) -> torch.device:
    """Rank ``rank``'s device: ``cuda:rank`` for a CUDA run, else
    ``device`` itself."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.device("cuda", rank)
    return device


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, device, fn, args) -> None:
    dev = rank_device(device, rank)
    multihost.initialize(f"127.0.0.1:{port}", world, rank, device=dev)
    try:
        fn(rank, dev, *args)
    finally:
        multihost.shutdown()


def spawn(fn, num_devices: int, device, *args) -> None:
    """Run ``fn(rank, device, *args)`` in ``num_devices`` spawned processes,
    each in a process group of that size (NCCL on CUDA devices, gloo on
    the CPU); returns when every rank is done
    and raises if one failed.  ``fn`` must be importable (a module-level
    function)."""
    check_device_count(num_devices, device)
    torch.multiprocessing.spawn(
        _rank_main, args=(num_devices, free_port(), str(device), fn, args),
        nprocs=num_devices, join=True)


def reduce_gradients(params, *sums: torch.Tensor):
    """Average the gradients of ``params`` over the ranks, in place, and
    sum ``sums`` (0-d tensors) over them, in one all-reduce of one flat f32
    bucket; returns the summed ``sums``.  Under a process group this runs
    for any world size, one included (a sum over one rank and a division by
    1 change no bit)."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = _flatten_dense_tensors(
        [g.float() for g in grads] + [s.float().reshape(1) for s in sums])
    dist.all_reduce(flat)
    n = flat.numel() - len(sums)
    flat[:n].div_(dist.get_world_size())
    out = _unflatten_dense_tensors(flat[:n], grads)
    for g, v in zip(grads, out):
        g.copy_(v)
    return tuple(flat[n + i].reshape(()) for i in range(len(sums)))


def sum_across(value: torch.Tensor) -> torch.Tensor:
    """``value`` summed over the ranks (a copy; the input is left alone)."""
    out = value.clone()
    if multihost.is_initialized():
        dist.all_reduce(out)
    return out
