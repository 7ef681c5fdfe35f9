"""Weight bridge: the reference package's parameters, as numpy, -> torch.

``from_numpy_params(tree, device)`` maps a nested dict of numpy arrays
(``np.asarray`` of each leaf of a ``repro`` parameter pytree) to the same
dict of torch tensors.  int8, uint8 and float containers copy as they
are.  bfloat16 leaves arrive as an ``ml_dtypes`` bfloat16 array, which
torch cannot read directly: their bits are viewed as uint16, then as
``torch.int16``, then as ``torch.bfloat16`` — exact, and with no import
of ``ml_dtypes`` or ``jax``.
"""
from __future__ import annotations

import numpy as np
import torch


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).view(np.int16)
        t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def from_numpy_params(tree, device="cpu"):
    """Nested dicts of numpy arrays -> the same dicts of torch tensors."""
    if isinstance(tree, dict):
        return {k: from_numpy_params(v, device) for k, v in tree.items()}
    return _leaf(tree, device)
