"""The paper's experiments on the port (counterparts of the repo's
``benchmarks/``): ``fig9_slice_crs``, ``fig10_hetero``."""
