"""Checkpoints (port of ``repro.checkpoint``): ``save_checkpoint``,
``restore_latest`` and ``CheckpointManager`` in the reference's file format."""
from .manager import CheckpointManager, list_checkpoints, restore_latest, save_checkpoint

__all__ = ["CheckpointManager", "list_checkpoints", "restore_latest", "save_checkpoint"]
