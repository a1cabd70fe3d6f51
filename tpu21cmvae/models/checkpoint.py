"""Atomic pytree checkpointing.

First-class save/load — the reference's ``DirectEmulator.save`` raises
``NotImplementedError`` (reference ``emulator.py:441-442``) and its model
files are meaningless without the training data the normalization
statistics are recomputed from (reference ``preprocess.py:88-101``). Here
a checkpoint is a single ``.npz`` bundling any pytree of arrays — model
weights, the Normalizer constants, optimizer state, epoch counter, RNG
key — plus a JSON-encoded structure spec and user metadata, written
atomically (temp file + ``os.replace``) so a preempted job never
sees a torn file.
"""

from __future__ import annotations

import json
from typing import Any, Optional, Tuple

import jax
import numpy as np

_FORMAT_VERSION = 1


def save_checkpoint(path: str, tree, metadata: Optional[dict] = None) -> str:
    """Save any pytree of arrays/scalars to ``path`` atomically."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    arrays = {f"leaf_{i}": np.asarray(leaf) for i, leaf in enumerate(leaves)}
    header = json.dumps(
        {
            "format_version": _FORMAT_VERSION,
            "treedef": str(treedef),
            "n_leaves": len(leaves),
            "metadata": metadata or {},
        }
    )
    from tpu21cmvae.utils.io import atomic_write

    with atomic_write(path) as f:
        np.savez(
            f, __header__=np.frombuffer(header.encode(), dtype=np.uint8), **arrays
        )
    return path


def load_checkpoint(path: str, like=None) -> Tuple[Any, dict]:
    """Load a checkpoint. Returns ``(tree, metadata)``.

    If ``like`` (a pytree with the same structure as what was saved) is
    given, the result is unflattened into that structure; otherwise a flat
    list of leaves is returned.
    """
    with np.load(path) as data:
        header = json.loads(bytes(data["__header__"]).decode())
        version = header.get("format_version")
        if version != _FORMAT_VERSION:
            raise ValueError(
                f"Checkpoint {path!r} has format_version {version!r}; this "
                f"build reads version {_FORMAT_VERSION}"
            )
        n = header["n_leaves"]
        leaves = [data[f"leaf_{i}"] for i in range(n)]
    if like is not None:
        _, treedef = jax.tree_util.tree_flatten(like)
        if treedef.num_leaves != n:
            raise ValueError(
                f"Checkpoint {path!r} has {n} leaves; template has "
                f"{treedef.num_leaves}"
            )
        # same leaf COUNT does not mean same STRUCTURE — a mismatched
        # template would silently bind arrays to the wrong slots
        stored = header.get("treedef")
        if stored is not None and stored != str(treedef):
            raise ValueError(
                f"Checkpoint {path!r} structure does not match the "
                f"template:\n  stored:   {stored}\n  template: {treedef}"
            )
        tree = jax.tree_util.tree_unflatten(treedef, leaves)
    else:
        tree = leaves
    return tree, header["metadata"]


def read_checkpoint_meta(path: str) -> dict:
    """Read only the metadata header (the weight arrays in the npz are
    lazy — this does not materialize them)."""
    with np.load(path) as data:
        header = json.loads(bytes(data["__header__"]).decode())
    return header["metadata"]


def unflatten_like(template, leaves, source: str = "checkpoint"):
    """Rebuild a pytree with ``template``'s structure from a flat leaf
    list (one :func:`load_checkpoint` read, no second file parse)."""
    treedef = jax.tree_util.tree_structure(template)
    if treedef.num_leaves != len(leaves):
        raise ValueError(
            f"{source} has {len(leaves)} leaves; template has "
            f"{treedef.num_leaves}"
        )
    return jax.tree_util.tree_unflatten(treedef, leaves)
