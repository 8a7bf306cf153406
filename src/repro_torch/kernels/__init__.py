"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version and its dispatching ``ops`` entry."""
from __future__ import annotations


def _wrappers():
    from repro_torch.kernels.crs import kernel as KC
    from repro_torch.kernels.sliced_mvm import kernel as KM
    from repro_torch.kernels.sliced_opa import kernel as KO

    return {"mvm_sliced_fused": KM.mvm_sliced_fused, "mvm_sliced": KM.mvm_sliced, "opa_fused": KO.opa_fused,
            "opa_dense": KO.opa_dense, "opa_deposit": KO.opa_deposit, "opa_im2col": KO.opa_im2col, "crs": KC.crs}


def launch_counts() -> dict:
    """Every kernel wrapper's launches since the last ``reset_launch_counts``
    by instance, ``"<kernel>/<instance>"`` (K3 has one instance,
    ``"crs/crs"``): real launches only (launches on meta tensors are
    ``common.fake_work.launches``, under the same keys)."""
    out = {}
    for name, fn in _wrappers().items():
        if name == "crs":
            counts = {"crs": fn.launches}
        else:
            counts = fn.instances
        out.update({f"{name}/{k}": int(v) for k, v in counts.items() if v})
    return out


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch counts to 0."""
    for fn in _wrappers().values():
        fn.launches = 0
        if hasattr(fn, "transpose_launches"):
            fn.transpose_launches = 0
        if hasattr(fn, "instances"):
            fn.instances.clear()
