"""Chain: linear composition of Blocks with static rate planning (port of
tpusdr/graph/chain.py).

Every block's rate ratio is a static rational, so the chain's shapes,
granule (the lcm of what each stage needs) and history are computed at
build time.  The per-block carries live in a dict keyed by block name.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Iterable, Sequence

import torch
from torch import nn

from tpusdr_torch.graph.block import Block
from tpusdr_torch.utils.numerics import lcm


class Chain(Block):
    """A linear pipeline of single-input blocks, itself usable as a Block."""

    def __init__(self, blocks: Iterable[tuple[str, Block] | Block]):
        super().__init__()
        named: list[tuple[str, Block]] = []
        for i, b in enumerate(blocks):
            named.append(b if isinstance(b, tuple) else (f"{i}_{b.__class__.__name__}", b))
        names = [n for n, _ in named]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate block names in chain: {names}")
        for n, b in named:
            if b.n_inputs != 1:
                raise ValueError(f"chain block {n!r} has {b.n_inputs} inputs")
        self.stages = nn.ModuleDict(named)
        self._recompute_plan()

    @property
    def blocks(self) -> list[tuple[str, Block]]:
        return list(self.stages.items())

    def _recompute_plan(self) -> None:
        named = self.blocks
        ratio = Fraction(1)
        gran = 1
        for _, b in named:
            # need (n * ratio) % b.granule == 0 for every tick length n
            num, den = ratio.numerator, ratio.denominator
            g = b.granule * den
            gran = lcm(gran, g // math.gcd(num, g))
            ratio *= Fraction(b.up, b.down)
        self._granule = gran
        self.up, self.down = ratio.numerator, ratio.denominator

        hist = Fraction(0)
        r = Fraction(1)
        for _, b in named:
            hist += Fraction(b.history, 1) / r
            r *= Fraction(b.up, b.down)
        self.history = int(hist.__ceil__())
        if named:
            self.in_dtype = named[0][1].in_dtype
            self.out_dtype = named[-1][1].out_dtype

    @property
    def granule(self) -> int:
        return self._granule

    def get_block(self, name: str) -> Block:
        return self.stages[name]

    def init_state(self, batch_shape: Sequence[int] = (), device=None) -> dict:
        return {name: b.init_state(batch_shape, device) for name, b in self.blocks}

    def apply(self, state: dict, x: torch.Tensor):
        new_state = {}
        for name, b in self.blocks:
            new_state[name], x = b.apply(state[name], x)
        return new_state, x

    def out_len(self, in_len: int) -> int:
        n = in_len
        for _, b in self.blocks:
            n = b.out_len(n)
        return n
