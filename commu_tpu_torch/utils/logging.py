"""Run logging (reference: logger.py:1-11, commu/model/exp_utils.py:7-37).

Single-process runs get one ``train.log`` plus console.  Multi-host runs get
the reference's layout (exp_utils.py:19-36): a per-rank file
``train_rank{N}.log`` and console output on rank 0 only.
"""
from __future__ import annotations

import logging
import sys
from pathlib import Path
from typing import Optional


def configure_logging(work_dir: Optional[str] = None,
                      name: str = "ComMU",
                      rank: Optional[int] = None,
                      stream=None) -> logging.Logger:
    """``rank=None`` — single-process layout; ``rank=N`` — multi-host layout
    (per-rank file, console only on rank 0).  ``stream`` overrides the
    console destination — serving mode logs to stderr so stdout stays a
    clean JSON protocol channel."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    if rank is None or rank == 0:
        console = logging.StreamHandler(stream or sys.stdout)
        console.setFormatter(fmt)
        logger.addHandler(console)
    if work_dir is not None:
        Path(work_dir).mkdir(parents=True, exist_ok=True)
        fname = "train.log" if rank is None else f"train_rank{rank}.log"
        fh = logging.FileHandler(str(Path(work_dir) / fname))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger
