"""Tree checkpointing (counterpart of ``repro/checkpoint/store.py``): npz
files keyed by the leaves' paths in a tree of dicts, lists and tuples
whose leaves are tensors or numpy arrays.

A leaf's name is what ``jax.tree_util.keystr`` gives for the same nested
dict (``['flat']``, ``['opt']['m']``, ``['opt'][0]``; dict keys sorted),
so a checkpoint has the reference's layout. Writes are atomic (tmp +
rename) into ``step_%08d.npz``; bfloat16 is stored as its float32 upcast.
``restore`` checks every leaf's presence, shape and dtype against an
example tree.
"""
from __future__ import annotations

import os
import re
import tempfile

import numpy as np
import torch


def _flatten_with_names(tree, prefix: str = "") -> list:
    """``[(name, leaf)]`` in ``jax.tree_util.tree_leaves_with_path``'s
    order; ``None`` and empty containers hold no leaves."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _flatten_with_names(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree)
                for pair in _flatten_with_names(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            # npz has no bfloat16: the lossless float32 upcast
            leaf = leaf.float()
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, tree) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = {name: _to_numpy(leaf) for name, leaf in _flatten_with_names(tree)}
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    return path


def latest_step(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for fn in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)\.npz", fn)
        if m:
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def _stored_dtype(ref) -> np.dtype:
    """The npz dtype a leaf like ``ref`` is stored as."""
    if isinstance(ref, torch.Tensor):
        dtype = torch.float32 if ref.dtype == torch.bfloat16 else ref.dtype
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.asarray(ref).dtype


def restore(ckpt_dir: str, step: int, like):
    """Restore into the structure of ``like``, every leaf checked for its
    shape and stored dtype. Numpy leaves come back as numpy, exactly (the
    float64 eps history, the int64 cohort sizes); tensor leaves as tensors
    of the reference leaf's dtype on its device."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    leaves = []
    with np.load(path) as data:
        for name, ref in _flatten_with_names(like):
            if name not in data:
                raise KeyError(f"checkpoint missing leaf {name}")
            arr = data[name]
            shape = tuple(ref.shape) if isinstance(ref, torch.Tensor) else np.shape(ref)
            if tuple(arr.shape) != shape:
                raise ValueError(f"shape mismatch for {name}: ckpt {arr.shape} vs {shape}")
            if arr.dtype != _stored_dtype(ref):
                raise ValueError(f"dtype mismatch for {name}: ckpt {arr.dtype} vs "
                                 f"{_stored_dtype(ref)}")
            if isinstance(ref, torch.Tensor):
                leaves.append(torch.from_numpy(arr).to(device=ref.device, dtype=ref.dtype))
            else:
                leaves.append(np.array(arr))
    return _unflatten(like, iter(leaves))
