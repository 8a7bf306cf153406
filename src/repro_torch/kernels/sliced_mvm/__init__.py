from .ops import mvm_sliced_fused, mvm_sliced_fused_batched

__all__ = ["mvm_sliced_fused", "mvm_sliced_fused_batched"]
