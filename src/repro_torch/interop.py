"""Convert state of the JAX package into the port's layouts.

``params_from_jax``: the JAX parameter tree stacks the layers of each
block kind on a leading axis (``blocks["attn"][name]`` is (n_layers, ...))
and keeps INT4 weights as ``QuantizedWeight(packed, scale)``.
``cache_from_jax``: one layer's packed ``AsymKVCache``.  The caller hands
the state over with every leaf a numpy array (``jax.tree.map(np.asarray,
tree)``); this module imports neither JAX nor the JAX package, so both
sides of a parity test compute from the same bytes.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.kvcache import AsymKVCache
from repro_torch.layers.common import QuantizedWeight


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)                     # a writable copy torch may own
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _leaf(x, device, index=None):
    if hasattr(x, "packed") and hasattr(x, "scale"):
        return QuantizedWeight(_leaf(x.packed, device, index),
                               _leaf(x.scale, device, index))
    a = np.asarray(x)
    return _tensor(a if index is None else a[index], device)


def params_from_jax(tree: Dict, device="cpu") -> Dict:
    """JAX parameter tree (numpy leaves) -> the port's parameter tree."""
    if set(tree["blocks"]) != {"attn"}:
        raise NotImplementedError(
            f"block kinds {sorted(tree['blocks'])}: only 'attn' is ported")
    out = {k: _leaf(v, device) for k, v in tree.items() if k != "blocks"}
    stacked = tree["blocks"]["attn"]
    n_layers = np.asarray(stacked["ln1"]).shape[0]
    out["layers"] = [{k: _leaf(v, device, i) for k, v in stacked.items()}
                     for i in range(n_layers)]
    return out


def cache_from_jax(cache, device="cpu") -> AsymKVCache:
    """One layer's JAX ``AsymKVCache`` (numpy or array leaves) -> the
    port's cache with the same bytes and length."""
    fields = {name: _tensor(getattr(cache, name), device)
              for name in AsymKVCache.__dataclass_fields__
              if name != "length"}
    return AsymKVCache(**fields, length=int(np.asarray(cache.length)))


__all__ = ["params_from_jax", "cache_from_jax"]
