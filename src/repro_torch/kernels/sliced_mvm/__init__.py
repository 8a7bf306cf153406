from .ops import (mvm_sliced, mvm_sliced_batched, mvm_sliced_folded, mvm_sliced_fused, mvm_sliced_fused_batched,
                  mvm_sliced_sharded)

__all__ = ["mvm_sliced", "mvm_sliced_batched", "mvm_sliced_folded", "mvm_sliced_fused", "mvm_sliced_fused_batched",
           "mvm_sliced_sharded"]
