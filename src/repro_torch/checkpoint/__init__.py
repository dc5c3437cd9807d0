"""Round-indexed checkpoints in the JAX package's file format."""
from repro_torch.checkpoint.checkpointer import Checkpointer, load_pytree, save_pytree

__all__ = ["Checkpointer", "load_pytree", "save_pytree"]
