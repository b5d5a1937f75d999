"""The training data pipeline (``data/pipeline.py``)."""
from .pipeline import DataConfig, SyntheticLM, PackedFileDataset, host_slice

__all__ = ["DataConfig", "SyntheticLM", "PackedFileDataset", "host_slice"]
