"""Generalized-bicycle (GB) codes with overcomplete check matrices, read
from the matrix file a configuration names: the ``gb_oc`` code family of
``codes.build_code``.

Panteleev and Kalachev (arXiv:1904.02703) decode their GB codes with BP on
redundant check matrices: every row a check of the code, many more rows
than its rank.  The file is an ``.npz`` whose array ``pcm`` stacks the X
checks over the Z checks.  A configuration's ``code`` entry gives its path
from the checkout's root (``npz``), its SHA-256 (``sha256``), refused where
the file's differs, and the rows of each side (``rows``): hx is the first
``rows`` rows, hz the next ``rows``.  ``codes.build_code`` then holds both
to its checks (binary, CSS, n and k).  No lift: the decoders take the
gather layout.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

__all__ = ["ROOT", "build"]

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build(spec: dict):
    """(hx, hz, None) of a ``gb_oc`` entry; ValueError where the file's
    SHA-256 is not the configured one or it has fewer rows than two sides."""
    path = os.path.join(ROOT, spec["npz"])
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if digest != spec["sha256"]:
        raise ValueError(f"{spec['npz']}: SHA-256 {digest}, configured {spec['sha256']}")
    with np.load(path, allow_pickle=False) as data:
        pcm = np.asarray(data["pcm"], np.int64)
    rows = int(spec["rows"])
    if pcm.ndim != 2 or pcm.shape[0] < 2 * rows:
        raise ValueError(f"{spec['npz']}: pcm {pcm.shape} holds no two sides of {rows} rows")
    return pcm[:rows], pcm[rows:2 * rows], None
