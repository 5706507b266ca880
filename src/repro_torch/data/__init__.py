"""Data substrate of the port: the reference's deterministic synthetic LM
pipeline with host prefetch, in NumPy; the batches move to the device at
the train step."""

from .pipeline import PrefetchIterator, SyntheticLMDataset

__all__ = ["SyntheticLMDataset", "PrefetchIterator"]
