"""Carry parameters and stream state across from the JAX package.

The JAX package's carries are pytrees of planar ``Complex(re, im)`` pairs,
float32 arrays and uint32 NCO phases.  Taken to numpy with
``jax.tree.map(np.asarray, state)``, pairs arrive as 2-tuples of float32
arrays, phases as uint32 scalars and sample counts as int32 scalars.
``state_from_numpy`` maps that onto the port's carries (complex64 tensors,
float32 tensors, Python-int phases, int32 tensors); ``state_to_numpy`` goes
back, so carries compare value for value.  The AM chain's carries are of
these kinds too: ``DcBlock``'s {"x1", "y1"} float32 arrays, a
``SampleCountMonitor``'s int32 count; ``IqToComplex`` and ``QuadAmDemod``
carry nothing.

``block_params_from_numpy`` builds a port block from the numbers of a JAX
block (taps, NCO increment, gain, IIR coefficients) rather than from its
design parameters alone; a ``Fir``'s mode, an ``IqToComplex``'s
input_format and a ``DcBlock``'s pole are constructor arguments like any
other.
"""

from __future__ import annotations

import numpy as np
import torch

from tpusdr_torch.graph.block import Block
from tpusdr_torch.graph.chain import Chain
from tpusdr_torch.graph.registry import create_block
from tpusdr_torch.ops import cplx


def _is_pair(tree) -> bool:
    return (
        isinstance(tree, tuple)
        and len(tree) == 2
        and all(isinstance(a, np.ndarray) and a.dtype == np.float32 for a in tree)
        and tree[0].shape == tree[1].shape
    )


def state_from_numpy(tree, device=None):
    """JAX carry (numpy leaves) -> the port's carry on ``device``."""
    if isinstance(tree, dict):
        return {k: state_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        tree = tuple(tree)  # a namedtuple pair may index its arrays instead
    if _is_pair(tree):
        return cplx.pair_to_tensor(tree[0], tree[1], device)
    if isinstance(tree, tuple):
        return tuple(state_from_numpy(v, device) for v in tree)
    a = np.asarray(tree)
    if a.dtype == np.uint32:
        return int(a)
    if a.dtype == np.int32:
        return torch.from_numpy(a.copy()).to(device)
    return cplx.from_numpy(a, device)


def state_to_numpy(state):
    """The port's carry -> the JAX layout with numpy leaves."""
    if isinstance(state, dict):
        return {k: state_to_numpy(v) for k, v in state.items()}
    if isinstance(state, tuple):
        return tuple(state_to_numpy(v) for v in state)
    if isinstance(state, int):
        return np.asarray(state, np.uint32)
    if state.is_complex():
        return cplx.tensor_to_pair(state)
    return cplx.to_numpy(state)


def block_params_from_numpy(kind: str, params: dict) -> Block:
    """Port block of registry type ``kind`` holding exactly the given
    numbers.  ``params`` are the constructor arguments (numpy taps
    included) plus optional overrides: ``inc`` (uint32 NCO increment) and
    ``a``, ``b`` (one-pole IIR coefficients)."""
    params = dict(params)
    inc = params.pop("inc", None)
    a, b = params.pop("a", None), params.pop("b", None)
    blk = create_block(kind, params)
    if inc is not None:
        blk.set_inc(int(inc))
    if a is not None:
        blk.set_coeffs(float(a), float(b))
    return blk


def chain_from_numpy(stages) -> Chain:
    """Chain of ``block_params_from_numpy`` blocks from (name, kind, params)."""
    return Chain([(name, block_params_from_numpy(kind, p)) for name, kind, p in stages])

