"""Helpers shared by the ``test_torch_*`` parity tests (this module holds
no tests): move arrays of the JAX package into the PyTorch port and compare
packed caches region by region."""
import numpy as np
import torch



def to_torch(x, device="cpu") -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(device)


def region_mismatches(jax_cache, torch_cache, names=None):
    """{name: number of differing elements} for every field that differs."""
    names = names or list(torch_cache.tensors())
    out = {}
    for name in names:
        a = np.asarray(getattr(jax_cache, name))
        b = getattr(torch_cache, name).cpu().numpy()
        if a.shape != b.shape:
            out[name] = f"shape {a.shape} vs {b.shape}"
        elif not np.array_equal(a, b):
            out[name] = int((a != b).sum())
    return out


def rel_err(ref, got) -> float:
    """max |ref - got| / max |ref|."""
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-30))
