"""Preprocess pipeline facade (reference: commu/preprocessor/pipeline.py:12-39).

A copy of ``commu_tpu/preprocess/pipeline.py``."""
from __future__ import annotations

import logging
import time
from multiprocessing import cpu_count
from pathlib import Path
from typing import Union

from .preprocessor import Preprocessor

logger = logging.getLogger("ComMU")


class PreprocessPipeline:
    def __call__(self, root_dir: Union[str, Path], csv_path: Union[str, Path],
                 num_cores: int = max(1, cpu_count() - 2)) -> None:
        preprocessor = Preprocessor(csv_path=csv_path)
        logger.info("Initialized preprocessor")
        logger.info("Start preprocessing")
        start = time.perf_counter()
        preprocessor.preprocess(root_dir=Path(root_dir), num_cores=num_cores)
        logger.info("Finished preprocessing in %.3fs", time.perf_counter() - start)
