from .pipeline import SyntheticLMDataset

__all__ = ["SyntheticLMDataset"]
