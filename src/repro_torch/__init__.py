"""PANTHER on PyTorch/CUDA: the port of ``repro`` (JAX/Pallas) to an NVIDIA
Hopper card.

The package mirrors ``repro``'s module layout and names, so each function
has its counterpart at the same path (``repro.core.mvm.fidelity_read`` ->
``repro_torch.core.mvm.fidelity_read``). It imports ``torch`` only, never
JAX and nothing of ``repro``. Parameters are plain nested dicts of tensors
with the same '/'-joined leaf paths as the JAX trees (stacked layer groups
keep their leading ``[L, ...]`` axis), so ``convert.py`` carries weights
across one leaf at a time.

Entry points that create tensors take ``device=`` and default to ``cuda``;
without a card they raise instead of running on the CPU (see
:func:`repro_torch.device.resolve`). Every TPU kernel on the ported path is a
hand-written Hopper kernel; its plain PyTorch version sits beside it and
runs only for tensors that lie on the CPU.
"""
