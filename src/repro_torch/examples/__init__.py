"""Runnable examples on the port (counterparts of the repo's
``examples/``): ``quickstart``, ``train_lm``, ``serve_batched``,
``energy_report``, ``isa_energy_report``."""
