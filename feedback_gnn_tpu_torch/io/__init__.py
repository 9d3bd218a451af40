"""Persistence: parameter-tree checkpoints in the JAX package's npz layout."""

from .checkpoint import load_pytree, save_pytree
