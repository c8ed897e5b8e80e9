"""Data parallelism over ``torch.distributed``: the process group and its
helpers (``multihost``), the per-rank launch and the step's reductions
(``mesh``).  PyTorch counterpart of ``commu_tpu/parallel/``."""
from . import mesh, multihost

__all__ = ["mesh", "multihost"]
