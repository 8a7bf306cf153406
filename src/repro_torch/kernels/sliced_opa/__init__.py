from .ops import opa_deposit, opa_dense_update, opa_device_update, opa_fused, opa_fused_update, opa_im2col_update

__all__ = ["opa_deposit", "opa_dense_update", "opa_device_update", "opa_fused", "opa_fused_update",
           "opa_im2col_update"]
