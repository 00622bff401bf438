"""Parameter trees of the port's models: nested dicts and lists of
tensors, as the JAX package's are of arrays.  ``tree_from_jax`` carries
a JAX tree across (``jax.tree_util.tree_map(np.asarray, params)``: bf16
leaves through their ``np.uint16`` bits, so no ``ml_dtypes`` is needed
here), with a per-leaf layout change where a model needs one."""

import numpy as np
import torch


def tensor_from_numpy(arr):
    """A numpy leaf as a CPU tensor of the same dtype (bf16 by its
    bits)."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def tree_from_jax(tree, device, leaf=None, key=None):
    """A JAX parameter tree (numpy leaves) as the port's, same structure,
    on ``device``.  ``leaf(key, tensor, device)``, when given, places each
    leaf (``key`` is the name of the dict entry that holds it)."""
    if isinstance(tree, dict):
        return {k: tree_from_jax(v, device, leaf, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_from_jax(v, device, leaf, key) for v in tree]
    t = tensor_from_numpy(tree)
    return t.to(device) if leaf is None else leaf(key, t, device)


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_cast(tree, dtype):
    """Every floating leaf cast to ``dtype`` (layouts kept)."""
    return tree_map(lambda t: t.to(dtype), tree)


def tree_leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out
