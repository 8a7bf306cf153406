from .ops import crs

__all__ = ["crs"]
