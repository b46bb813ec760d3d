"""Stream-state checkpoint and resume (port of tpusdr/graph/checkpoint.py).

The whole stream state is one explicit tree: nested dicts (and tuples) of
tensors.  ``save_state`` stores every leaf under its path ("rf/tail",
"shift") as a numpy array, an NCO phase (a 0-d int64 tensor marked by
``ops/osc.py``) as a uint32 scalar, as the JAX package stores it;
``load_state`` checks the stored keys, shapes and dtypes against a freshly
initialised state and puts each tensor on the device of its counterpart
there.  A checkpoint written while phases were Python ints (stored as
uint32 scalars too) loads the same way.  One widening is accepted: a count
stored as int32 (as ``SampleCountMonitor`` kept it before it counted in
int64) loads into an int64 leaf.  (The JAX package compares the printed
tree structure and never the dtypes.)
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from tpusdr_torch.ops import osc

_SEP = "/"


def _flatten(tree: Any, prefix: str, out: dict) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            if _SEP in str(k):
                raise ValueError(f"state key {k!r} holds the path separator {_SEP!r}")
            _flatten(v, f"{prefix}{_SEP}{k}" if prefix else str(k), out)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{_SEP}{i}" if prefix else str(i), out)
    else:
        out[prefix] = tree


def _leaf_to_numpy(leaf) -> np.ndarray:
    if osc.is_phase(leaf):
        return leaf.detach().cpu().numpy().astype(np.uint32)
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, int):  # a bare uint32 value, as phases were once carried
        return np.asarray(leaf, np.uint32)
    raise TypeError(f"cannot checkpoint a state leaf of type {type(leaf).__name__}")


def save_state(path: str, state: Any) -> None:
    """Write ``state`` to ``path`` (numpy's .npz; the suffix is added when
    missing, as ``np.savez`` does)."""
    leaves: dict = {}
    _flatten(state, "", leaves)
    np.savez(path, **{k: _leaf_to_numpy(v) for k, v in leaves.items()})


def load_state(path: str, like: Any) -> Any:
    """Load a checkpoint into the structure of ``like`` (a freshly
    ``init_state()``'d tree).  Keys, shapes and dtypes must match (a stored
    int32 count widens into an int64 leaf); tensors
    come back on the device of their counterpart in ``like``."""
    want: dict = {}
    _flatten(like, "", want)
    with np.load(path) as data:
        saved = set(data.files)
        if saved != set(want):
            raise ValueError(
                "checkpoint keys do not match the state: "
                f"missing {sorted(set(want) - saved)}, unexpected {sorted(saved - set(want))}"
            )
        loaded = {}
        for key, proto in want.items():
            arr = data[key]
            ref = _leaf_to_numpy(proto)
            if arr.shape != ref.shape:
                raise ValueError(f"checkpoint leaf {key!r} has shape {arr.shape}, expected {ref.shape}")
            if arr.dtype == np.int32 and ref.dtype == np.int64:
                arr = arr.astype(np.int64)
            if arr.dtype != ref.dtype:
                raise ValueError(f"checkpoint leaf {key!r} has dtype {arr.dtype}, expected {ref.dtype}")
            if osc.is_phase(proto):
                loaded[key] = osc.as_phase(int(arr), proto.device) if arr.ndim == 0 else osc.as_phases(
                    arr.tolist(), proto.device)
            else:
                loaded[key] = torch.from_numpy(arr.copy()).to(proto.device)
    return _rebuild(like, "", loaded)


def _rebuild(like: Any, prefix: str, loaded: dict) -> Any:
    if isinstance(like, dict):
        return {k: _rebuild(v, f"{prefix}{_SEP}{k}" if prefix else str(k), loaded) for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        return type(like)(
            _rebuild(v, f"{prefix}{_SEP}{i}" if prefix else str(i), loaded) for i, v in enumerate(like)
        )
    return loaded[prefix]
