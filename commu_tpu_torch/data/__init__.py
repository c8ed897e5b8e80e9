from .dataset import ComMUDataset, Batch

__all__ = ["ComMUDataset", "Batch"]
