"""Parameter-tree checkpoints, in the npz layout of the JAX package's
``io/checkpoint.py``, so that each package reads the other's files.

A tree is nested dicts and lists (or tuples) of tensors or arrays.  Each
leaf is stored under the "/"-joined path of its keys and list indices,
e.g. ``msg_mlp_x/0/kernel``; leaves are enumerated as JAX flattens a
pytree (dict keys sorted, sequences in order).  The reference's 12-array
pickles are read and written by ``decoders.gnn_feedback``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ["flatten_with_paths", "save_pytree", "load_pytree"]


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def flatten_with_paths(tree) -> dict:
    """{path: leaf} in JAX's leaf order."""
    return dict(_paths(tree))


def _to_numpy(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(tree, path: str):
    """Save a tree of tensors or arrays to ``path`` atomically: written
    under a per-process temporary name, then renamed."""
    flat = {k: _to_numpy(v) for k, v in flatten_with_paths(tree).items()}
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez_compressed(tmp, **flat)
    os.replace(tmp, path)


def _rebuild(like, leaves, prefix=()):
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves, prefix + (str(k),)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        out = [_rebuild(v, leaves, prefix + (str(i),)) for i, v in enumerate(like)]
        return type(like)(out)
    return leaves["/".join(prefix)]


def load_pytree(path: str, like, device=None):
    """Load a checkpoint into the structure of ``like``, mapping leaves by
    key (the file's order does not matter).  Tensor leaves of ``like`` come
    back as tensors of their dtype on ``device`` (default: the leaf's own
    device), other leaves as numpy arrays.  Raises KeyError for a leaf the
    file lacks."""
    leaves = {}
    with np.load(path, allow_pickle=False) as data:
        for key, ref in flatten_with_paths(like).items():
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = data[key]
            if isinstance(ref, torch.Tensor):
                arr = torch.as_tensor(arr, dtype=ref.dtype,
                                      device=ref.device if device is None else device)
            leaves[key] = arr
    return _rebuild(like, leaves)
