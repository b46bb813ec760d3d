"""tpusdr_torch.graph — Block, Chain, registry and the main-path blocks."""

from tpusdr_torch.graph.block import Block  # noqa: F401
from tpusdr_torch.graph.chain import Chain  # noqa: F401
from tpusdr_torch.graph.registry import create_block, get_registry, register_block  # noqa: F401
