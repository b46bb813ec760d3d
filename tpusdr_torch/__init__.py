"""tpusdr_torch — the tpusdr receiver pipeline in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

A port of the JAX package ``tpusdr`` (kept beside it as the reference):
the same streaming contract, ``apply(state, x) -> (state', y)`` with static
rational rates, granules and explicit carries, on ``torch.complex64``
streams.  Every TPU kernel on the ported path has a CUDA C++ counterpart in
``kernels/csrc/`` with a plain PyTorch version beside it; a CPU tensor
takes the plain version, a CUDA tensor the kernel.
"""

__version__ = "0.1.0"

from tpusdr_torch.graph.block import Block  # noqa: F401
from tpusdr_torch.graph.chain import Chain  # noqa: F401
from tpusdr_torch.graph.registry import get_registry, register_block  # noqa: F401
