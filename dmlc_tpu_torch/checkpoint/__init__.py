"""Sharded checkpoints in the JAX package's format (the port of
``dmlc_tpu/checkpoint``)."""

from .sharded import (  # noqa: F401
    CheckpointManager,
    CorruptCheckpoint,
    MissingLeaf,
    restore_pytree,
    save_pytree,
)
