"""The trained tree's check and the reference's copy of it.

``weights_digest.json`` holds, for each leaf of
``checkpoints/learned_frontend`` (its flax path joined by ``/``), its shape
and the SHA-256 of its float32 little-endian bytes, as an independent
reader of the orbax tree (orbax's own restore) read them. The port reads
the tree with its own reader at set-up; :func:`verify` holds every leaf of
what it read to the digest, so the reference and the port start from the
weights that the file stores.
"""
from __future__ import annotations

import hashlib
import json
import os

import numpy as np

DIGEST = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "weights_digest.json")


def flat_leaves(tree, prefix=""):
    """{``/``-joined path: array} of a nested tree."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flat_leaves(v, name))
        else:
            out[name] = v
    return out


def verify(tree) -> int:
    """Raise unless ``tree`` holds exactly the digest's leaves, each with
    its shape and bytes; returns the number of leaves."""
    with open(DIGEST) as f:
        want = json.load(f)
    got = flat_leaves(tree)
    if set(got) != set(want):
        raise ValueError(f"trained tree leaves differ from the digest: "
                         f"missing {sorted(set(want) - set(got))[:5]}, "
                         f"extra {sorted(set(got) - set(want))[:5]}")
    for name, (shape, sha) in want.items():
        a = np.ascontiguousarray(np.asarray(got[name]), dtype="<f4")
        if list(a.shape) != shape or \
                hashlib.sha256(a.tobytes()).hexdigest() != sha:
            raise ValueError(f"trained tree leaf {name} differs from the "
                             f"digest")
    return len(want)
