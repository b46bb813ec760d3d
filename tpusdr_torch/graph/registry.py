"""Node-type registry: string name -> Block builder (port of
tpusdr/graph/registry.py)."""

from __future__ import annotations

from typing import Callable

_REGISTRY: dict[str, Callable] = {}


def register_block(name: str):
    """Class/function decorator registering a Block builder under ``name``."""

    def deco(builder):
        _REGISTRY[name] = builder
        return builder

    return deco


def get_registry() -> dict[str, Callable]:
    import tpusdr_torch.graph.blocks  # noqa: F401  (populates the registry)

    return dict(_REGISTRY)


def create_block(type_name: str, params: dict | None = None):
    """Instantiate a registered block type from keyword params."""
    reg = get_registry()
    if type_name not in reg:
        raise KeyError(f"unknown node type {type_name!r}; registered: {sorted(reg)}")
    return reg[type_name](**(params or {}))
