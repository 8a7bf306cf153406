"""Runnable examples on the port (counterparts of the repo's
``examples/``): ``quickstart``, ``train_lm``."""
