"""The paper's experiments on the port (counterparts of the repo's
``benchmarks/``): ``fig9_slice_crs``, ``fig10_hetero``, ``isa_energy`` and the
analytic figures ``fig1_primitives``, ``fig11_sgd_energy``,
``fig12_minibatch_energy``, ``fig13_time``, ``fig14_variants``, ``fig15_gpu``."""
