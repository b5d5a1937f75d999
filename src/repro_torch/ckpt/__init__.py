"""Checkpoints: atomic, self-healing, on the JAX package's disk format."""
from .checkpoint import CheckpointManager

__all__ = ["CheckpointManager"]
