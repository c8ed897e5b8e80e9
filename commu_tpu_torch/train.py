"""Train the ComMU Transformer-XL on a CUDA device.

PyTorch counterpart of the root ``train.py``: the same flags where the port
supports them, plus ``--device`` (default ``cuda``; ``cpu`` only when asked
for explicitly, and then the kernels' plain versions run).

    python -m commu_tpu_torch.train --data_dir ./dataset/output_npy \\
        --work_dir ./workdir [--max_step N] [--resume] [--dtype float32] \\
        [--profile] [--set train.batch_size=16 ...]

The port trains one device at the config's dropout (``ModelConfig()``: 0.1
and 0.1, the masks drawn inside the kernels from seeds that follow the run's
seed and the step), with the XL memory of ``train.mem_length`` or, at
``--set train.mem_length=0``, without one.  ``--set model.attn_impl=xla``
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

It refuses, naming the work that brings each: ``--num_devices`` > 1 and
``--distributed`` with its rendezvous flags (data parallelism),
a ``COMMU_DROPOUT_BITS`` other than 8 or 16, and
the reference's probe levers that have no counterpart here
(``COMMU_INT8_DQ=1``, ``COMMU_INT8_DK=1``, ``COMMU_SOFTMAX=clamp``,
``COMMU_DEFER_NORM=1``, ``COMMU_SCALE_HOIST=1``).  Float32 matrix products
run in full float32 (TF32 is switched off here).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

_REFUSED = {
    "num_devices": "data parallelism (--num_devices > 1) is not ported yet; "
                   "it comes with the port of commu_tpu.parallel",
    "distributed": "multi-process training (--distributed, "
                   "--coordinator_address, --num_processes, --process_id) "
                   "is not ported yet; it comes with the port of "
                   "commu_tpu.parallel",
}

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
                   help="devices to use (only 1 is supported)")
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
                   help="(not supported here)")
    p.add_argument("--coordinator_address", type=str, default=None)
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
    if args.num_devices is not None and args.num_devices > 1:
        raise SystemExit(_REFUSED["num_devices"])
    if args.distributed or args.coordinator_address or \
            args.num_processes is not None or args.process_id is not None:
        raise SystemExit(_REFUSED["distributed"])

    from .config import get_default_cfg_training

    cfg = apply_overrides(get_default_cfg_training(), args.overrides)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu explicitly to run "
                         "the plain PyTorch versions of the kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    work_dir = args.work_dir if args.resume else \
        f"{args.work_dir}/{time.strftime('%Y%m%d-%H%M%S')}"
    from .utils.logging import configure_logging

    from .training import Trainer

    logger = configure_logging(work_dir)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    trainer = Trainer(args.data_dir, cfg, device=device, model_dtype=dtype,
                      work_dir=work_dir, profile=args.profile)
    logger.info("devices=1 (%s), global batch=%d, model dtype=%s, "
                "attention path=%s", device, cfg.train.batch_size, args.dtype,
                trainer.model.attn_impl)
    logger.info("numerics: %s", ", ".join(
        f"{name}={os.environ[name]}" for name in _LEVERS))
    if args.resume:
        trainer.maybe_resume()
    trainer.train(max_step=args.max_step)
    trainer.final_test()
    return work_dir


if __name__ == "__main__":
    main()
