"""Weight bridge: the reference package's parameters, as numpy, -> torch.

``from_numpy_params(tree, device)`` maps a nested dict of numpy arrays
(``np.asarray`` of each leaf of a ``repro`` parameter pytree) to the same
dict of torch tensors.  int8, uint8 and float containers copy as they
are.  bfloat16 leaves arrive as an ``ml_dtypes`` bfloat16 array, which
torch cannot read directly: their bits are viewed as uint16, then as
``torch.int16``, then as ``torch.bfloat16`` — exact, and with no import
of ``ml_dtypes`` or ``jax``.  The stacked ``(L, ...)`` LM parameter trees
convert as they are.  Leaves land on ``device``: CUDA unless the caller
passes another.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import resolve_device


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).view(np.int16)
        t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def from_numpy_params(tree, device="cuda"):
    """Nested dicts of numpy arrays -> the same dicts of torch tensors."""
    dev = resolve_device(device)

    def rec(node):
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        return _leaf(node, dev)

    return rec(tree)
