"""Weights from the JAX package's parameter tree, as the port's tensors.

``params_from_numpy`` takes the Llama param tree with numpy leaves (plain
arrays, or int8 ``{"q", "s"}`` dicts from ``quantize_params``) and returns
the same tree as torch tensors on a device, so both packages compute from one
set of weights. bfloat16 arrays (numpy's ``ml_dtypes`` extension type) are
carried bit for bit. ``load_npz`` reads such a tree stored flat, with
``/``-joined keys (``flatten``): that is how the distilled checkpoint travels
into the port without orbax.
"""

from __future__ import annotations

import numpy as np
import torch


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    return t.to(device)


def params_from_numpy(tree, device="cpu"):
    """Map every array leaf of a (nested dict) param tree to a tensor."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def flatten(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def load_npz(path, device="cpu") -> dict:
    """A flat npz param tree -> nested tensors on ``device``."""
    with np.load(path) as z:
        return params_from_numpy(unflatten({k: z[k] for k in z.files}), device)
