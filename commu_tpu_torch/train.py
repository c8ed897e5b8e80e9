"""Train the ComMU Transformer-XL on a CUDA device.

PyTorch counterpart of the root ``train.py``: the same flags where the port
supports them, plus ``--device`` (default ``cuda``; ``cpu`` only when asked
for explicitly, and then the kernels' plain versions run).

    python -m commu_tpu_torch.train --data_dir ./dataset/output_npy \\
        --work_dir ./workdir [--max_step N] [--resume] [--dtype float32] \\
        [--profile] [--set train.batch_size=16 ...]

The port trains at the config's dropout (``ModelConfig()``: 0.1 and 0.1,
the masks drawn inside the kernels from seeds that follow the run's seed,
the step and the rank), with the XL memory of ``train.mem_length`` or, at
``--set train.mem_length=0``, without one.

Data parallelism (``commu_tpu_torch.parallel``): ``--num_devices N``
starts N ranks from this process, rank r on ``cuda:r`` (or on the CPU with
``--device cpu``); it exits with a message when N exceeds the CUDA devices
the machine has.  ``--distributed --coordinator_address HOST:PORT
--num_processes N --process_id R`` makes this process rank R of N started
elsewhere, on ``--device`` (``cuda`` alone means ``cuda:R`` modulo the
devices).  The process group runs NCCL on CUDA devices and gloo on the
CPU.  Each rank trains on its rows of the global
batch ``train.batch_size`` at ``lr / N``; the gradients are averaged over
the ranks before the clip; rank 0 writes the checkpoints, the config and
the console log, every rank its own ``train_rank<R>.log``.  ``--set model.attn_impl=xla``
or ``--set model.clamp_len=N`` (N > 0) trains on the unfused attention path
(plain torch, no kernel: ``models.transformer_xl.resolve_attn_impl``).
``--profile`` traces steps [start + 4, start + 10) with ``torch.profiler``
into ``<work_dir>/profile/`` as a Chrome trace.

Numerics.  As the root ``train.py``, this entry point trains in the
reference's fast mode unless ``--precise_bd`` is given: it sets, for the
length of ``main`` and only where the caller has not exported a value,
``COMMU_BD_INT8=1`` (the forward's BD product on int8 operands),
``COMMU_BD_INT8_BWD=1`` (the backward's dphi product on int8 operands) and
``COMMU_DROPOUT_BITS=8`` (8 random bits a dropout decision: 26/256 at p =
0.1, every keep-scale following the realised rate).  ``--precise_bd`` sets
them to 0, 0 and 16: exact products and 16-bit draws.  The kernels read the
three variables at each call (``ops.fused_attention.bd_int8``,
``bd_int8_bwd``, ``ops.prng.dropout_bits``); ``main`` puts the environment
back as it found it.  ``COMMU_PROJ_IN_FWD=1`` and ``COMMU_O_IN_FFN=1`` switch
on the reference's two fused probes; the first has no int8 form and raises
under ``COMMU_BD_INT8=1``, so probe runs take ``--precise_bd``.

It refuses, naming the work that brings each: a ``COMMU_DROPOUT_BITS``
other than 8 or 16, and the reference's probe levers that have no
counterpart here
(``COMMU_INT8_DQ=1``, ``COMMU_INT8_DK=1``, ``COMMU_SOFTMAX=clamp``,
``COMMU_DEFER_NORM=1``, ``COMMU_SCALE_HOIST=1``).  Float32 matrix products
run in full float32 (TF32 is switched off here).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

# the numerics levers: (fast mode, --precise_bd), as the root train.py sets
# them
_LEVERS = {"COMMU_BD_INT8": ("1", "0"), "COMMU_BD_INT8_BWD": ("1", "0"),
           "COMMU_DROPOUT_BITS": ("8", "16")}
# levers of the reference's kernels that the port's kernels do not have: the
# value that switches each on
_UNPORTED = {"COMMU_INT8_DQ": "1", "COMMU_INT8_DK": "1",
             "COMMU_SOFTMAX": "clamp", "COMMU_DEFER_NORM": "1",
             "COMMU_SCALE_HOIST": "1"}


def select_numerics(precise_bd: bool) -> None:
    """Set the three levers in ``os.environ`` as the root ``train.py`` does:
    the exact mode outright, the fast mode only where the caller exported
    nothing (an exported ``COMMU_BD_INT8=0`` still wins)."""
    for name, (fast, precise) in _LEVERS.items():
        if precise_bd:
            os.environ[name] = precise
        else:
            os.environ.setdefault(name, fast)


def check_environment() -> None:
    """Exit with a message on a variable whose value the port cannot
    honour, rather than train in another mode than the caller asked for."""
    bits = os.environ.get("COMMU_DROPOUT_BITS", "16")
    if bits not in ("8", "16"):
        raise SystemExit(f"COMMU_DROPOUT_BITS={bits}: the port draws its "
                         "dropout masks at 8 or 16 bits")
    for name, on in _UNPORTED.items():
        if os.environ.get(name) == on:
            raise SystemExit(
                f"{name}={on} is a lever of the reference's kernels that "
                "the port's kernels do not have; unset it")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ComMU training (PyTorch/CUDA)")
    p.add_argument("--data_dir", type=str, required=True,
                   help="directory with {input,target}_{train,val}.npy")
    p.add_argument("--work_dir", type=str, required=True,
                   help="experiment directory (logs, config.yml, checkpoints)")
    p.add_argument("--num_devices", type=int, default=None,
                   help="data-parallel ranks started here, one a device")
    p.add_argument("--max_step", type=int, default=None,
                   help="override cfg.train.max_step")
    p.add_argument("--resume", action="store_true",
                   help="resume from work_dir/checkpoint_last.pt if present")
    p.add_argument("--dtype", choices=["bfloat16", "float32"],
                   default="bfloat16", help="activation/matmul dtype")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="SECTION.FIELD=VALUE",
                   help="config override, e.g. --set train.batch_size=16")
    p.add_argument("--profile", action="store_true",
                   help="trace steps [start+4, start+10) with torch.profiler "
                        "into <work_dir>/profile/")
    p.add_argument("--precise_bd", action="store_true",
                   help="exact numerics: float BD and dphi products and "
                        "16-bit dropout draws (COMMU_BD_INT8=0, "
                        "COMMU_BD_INT8_BWD=0, COMMU_DROPOUT_BITS=16) in "
                        "place of the default fast mode (int8 products, "
                        "8-bit draws)")
    p.add_argument("--distributed", action="store_true",
                   help="join a process group as one rank of a run started "
                        "elsewhere (needs the three flags below)")
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="host:port of rank 0's rendezvous")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cpu runs the kernels' plain versions")
    return p.parse_args(argv)


def apply_overrides(cfg, overrides):
    """Apply ``section.field=value`` overrides to the frozen config tree
    (the root train.py's rule: the value takes the field's type; booleans
    accept 1/true/yes)."""
    sections = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for item in overrides:
        key, _, raw = item.partition("=")
        section_name, _, field = key.partition(".")
        section = sections[section_name]
        current = getattr(section, field)  # KeyError/AttributeError on typos
        value = type(current)(raw) if not isinstance(current, bool) \
            else raw.lower() in ("1", "true", "yes")
        sections[section_name] = dataclasses.replace(section, **{field: value})
    return cfg.replace(**sections)


def main(argv=None) -> str:
    """Entry point; returns the work dir it trained in.  The numerics
    levers it sets live as long as the call: ``os.environ`` is put back on
    the way out, so a caller in the same process keeps its own mode."""
    args = parse_args(argv)
    saved = {name: os.environ.get(name) for name in _LEVERS}
    try:
        select_numerics(args.precise_bd)
        check_environment()
        return _run(args)
    finally:
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value


def _run(args) -> str:
    if (args.coordinator_address or args.num_processes is not None
            or args.process_id is not None) and not args.distributed:
        raise SystemExit("--coordinator_address, --num_processes and "
                         "--process_id take --distributed")
    if args.distributed and (not args.coordinator_address
                             or args.num_processes is None
                             or args.process_id is None):
        raise SystemExit("--distributed needs --coordinator_address, "
                         "--num_processes and --process_id")
    num_devices = args.num_devices or 1
    if args.distributed and args.num_devices not in (None, 1,
                                                     args.num_processes):
        raise SystemExit(f"--num_devices {args.num_devices} with "
                         f"--distributed: each of the {args.num_processes} "
                         "processes is one rank on one device")

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu explicitly to run "
                         "the plain PyTorch versions of the kernels")
    stamp = time.strftime('%Y%m%d-%H%M%S')
    if args.distributed:
        from .parallel import multihost

        if device.type == "cuda" and device.index is None:
            device = torch.device(
                "cuda", args.process_id % torch.cuda.device_count())
        multihost.initialize(args.coordinator_address, args.num_processes,
                             args.process_id, device=device)
        try:
            # process 0's timestamp names the run's directory on every rank
            return _train(args, device, multihost.broadcast_string(stamp),
                          rank=args.process_id)
        finally:
            multihost.shutdown()
    if num_devices > 1:
        from .parallel import mesh

        mesh.spawn(_rank, num_devices, device, args, stamp)
        return _work_dir(args, stamp)
    return _train(args, device, stamp)


def _rank(rank: int, device, args, stamp: str) -> None:
    """One rank of ``--num_devices N``: its process group is up (on its
    device); the numerics levers of the parent's ``main`` were inherited
    with its environment."""
    check_environment()
    _train(args, device, stamp, rank=rank)


def _work_dir(args, stamp: str) -> str:
    return args.work_dir if args.resume else f"{args.work_dir}/{stamp}"


def _train(args, device, stamp: str, rank=None) -> str:
    from .config import get_default_cfg_training

    cfg = apply_overrides(get_default_cfg_training(), args.overrides)

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    work_dir = _work_dir(args, stamp)
    from .utils.logging import configure_logging

    from .training import Trainer

    logger = configure_logging(work_dir, rank=rank)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    trainer = Trainer(args.data_dir, cfg, device=device, model_dtype=dtype,
                      work_dir=work_dir, profile=args.profile)
    logger.info("devices=%d (%s), global batch=%d, model dtype=%s, "
                "attention path=%s", trainer.world, device,
                cfg.train.batch_size, args.dtype, trainer.model.attn_impl)
    logger.info("numerics: %s", ", ".join(
        f"{name}={os.environ[name]}" for name in _LEVERS))
    if args.resume:
        trainer.maybe_resume()
    trainer.train(max_step=args.max_step)
    trainer.final_test()
    return work_dir


if __name__ == "__main__":
    main()
