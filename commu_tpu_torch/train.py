"""Train the ComMU Transformer-XL on a CUDA device.

PyTorch counterpart of the root ``train.py``: the same flags where the port
supports them, plus ``--device`` (default ``cuda``; ``cpu`` only when asked
for explicitly, and then the kernels' plain versions run).

    python -m commu_tpu_torch.train --data_dir ./dataset/output_npy \\
        --work_dir ./workdir [--max_step N] [--resume] [--dtype float32] \\
        [--set train.batch_size=16 ...]

The port trains one device at the config's dropout (``ModelConfig()``: 0.1
and 0.1, the masks drawn inside the kernels from seeds that follow the run's
seed and the step), in the exact mode of ``--precise_bd`` (accepted, and
always on), with the XL memory of ``train.mem_length`` or, at ``--set
train.mem_length=0``, without one.  ``COMMU_PROJ_IN_FWD=1`` and
``COMMU_O_IN_FFN=1`` switch on the reference's two fused probes.  It
refuses, naming the work that brings each:
``--num_devices`` > 1 and ``--distributed`` with its rendezvous flags (data
parallelism) and ``--profile`` (tracing).  Float32 matrix products run in
full float32 (TF32 is switched off here).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

_REFUSED = {
    "num_devices": "data parallelism (--num_devices > 1) is not ported yet; "
                   "it comes with the port of commu_tpu.parallel",
    "distributed": "multi-process training (--distributed, "
                   "--coordinator_address, --num_processes, --process_id) "
                   "is not ported yet; it comes with the port of "
                   "commu_tpu.parallel",
    "profile": "--profile is not ported yet; it comes with the tracing work "
               "on the port",
}


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
                   help="(not supported here)")
    p.add_argument("--precise_bd", action="store_true",
                   help="exact relative-position products (always the case "
                        "here: the int8 variants are not ported)")
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
    """Entry point; returns the work dir it trained in."""
    args = parse_args(argv)
    if args.num_devices is not None and args.num_devices > 1:
        raise SystemExit(_REFUSED["num_devices"])
    if args.distributed or args.coordinator_address or \
            args.num_processes is not None or args.process_id is not None:
        raise SystemExit(_REFUSED["distributed"])
    if args.profile:
        raise SystemExit(_REFUSED["profile"])

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
                      work_dir=work_dir)
    logger.info("devices=1 (%s), global batch=%d, model dtype=%s", device,
                cfg.train.batch_size, args.dtype)
    if args.resume:
        trainer.maybe_resume()
    trainer.train(max_step=args.max_step)
    trainer.final_test()
    return work_dir


if __name__ == "__main__":
    main()
