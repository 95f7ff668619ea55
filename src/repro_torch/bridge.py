"""Move parameter trees between the two packages as numpy arrays.

The reference's params, read with ``np.asarray`` leaf by leaf, are a
nested dict of numpy arrays (``ml_dtypes.bfloat16`` included).
``params_from_jax`` turns such a tree into torch tensors under the same
paths; ``params_to_numpy`` is the inverse.  Both take any nested dict,
so they move a whole train state too.  The two
packages' random generators differ, so this is the one way to give both
the same weights.  (Checkpoints do not come through here: they read and
write bf16 by its bits, without ``ml_dtypes``; see ``train/checkpoint.py``.)
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import Params, tree_map


def _is_bfloat16(dtype: np.dtype) -> bool:
    # ml_dtypes registers bfloat16 as a numpy extension dtype named so
    return dtype.name == "bfloat16"


def _to_torch(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if _is_bfloat16(a.dtype):
        # same bits, viewed as uint16 -> reinterpreted as bf16
        bits = torch.from_numpy(np.array(a, copy=True).view(np.uint16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_jax(tree: Params, device: str | torch.device = "cpu"
                    ) -> Params:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``:
    a param tree, or a whole train state of the reference (``params``,
    ``opt`` with ``mu``, ``nu`` and the int32 scalar ``step``, optionally
    ``error``)."""
    dev = torch.device(device)
    return tree_map(lambda _, a: _to_torch(a, dev), tree)


def params_to_numpy(tree: Params) -> Params:
    """Nested dict of tensors (params or a whole train state) -> nested
    dict of numpy arrays (bf16 as ``ml_dtypes.bfloat16``, ``opt/step`` an
    int32 scalar)."""
    return tree_map(lambda _, t: _to_numpy(t), tree)

