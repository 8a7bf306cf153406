from . import panther
from .panther import PantherConfig, SlicedTensor

__all__ = ["panther", "PantherConfig", "SlicedTensor"]
