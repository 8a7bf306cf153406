"""The (pod, data, model) mesh on ``torch.distributed`` (port of
``repro.distributed``): the sharding rules, the collectives, the fidelity
reads' mesh context and the rank's blocks of a sharded tree."""
from . import fidelity, sharding
from .collectives import compressed_psum, tile_psum

__all__ = ["fidelity", "sharding", "compressed_psum", "tile_psum"]
