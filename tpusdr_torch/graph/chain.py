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
from tpusdr_torch.utils import tracing
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

        # a block that adds a channel axis widens the batch of every block
        # after it (init_state); the last such block gives the channel count
        adders = [b for _, b in named if b.adds_channel_axis]
        self.adds_channel_axis = bool(adders)
        self.num_channels = adders[-1].num_channels if adders else 1
        if named:
            self.in_dtype = named[0][1].in_dtype
            self.out_dtype = named[-1][1].out_dtype

    @property
    def granule(self) -> int:
        return self._granule

    def get_block(self, name: str) -> Block:
        return self.stages[name]

    def update_block_parameters(self, name: str, **params) -> None:
        """Runtime parameter update on a member block.  Rate ratios must not
        change (every downstream shape would); a history change is folded
        back into the chain's plan."""
        b = self.get_block(name)
        old_rate = (b.up, b.down)
        b.update_parameters(**params)
        if (b.up, b.down) != old_rate:
            raise ValueError(
                f"update of {name!r} changed its rate {old_rate} -> "
                f"{(b.up, b.down)}; rebuild the chain instead"
            )
        self._recompute_plan()

    def update_block_parameters_json(self, name: str, payload) -> None:
        """JSON-payload form of update_block_parameters (camelCase keys)."""
        import json as _json

        from tpusdr_torch.graph.graph import translate_params

        if isinstance(payload, str):
            payload = _json.loads(payload)
        self.update_block_parameters(name, **translate_params(payload))

    def init_state(self, batch_shape: Sequence[int] = (), device=None) -> dict:
        state = {}
        shape = tuple(batch_shape)
        for name, b in self.blocks:
            state[name] = b.init_state(shape, device)
            if b.adds_channel_axis:
                shape = shape + (b.num_channels,)
        return state

    def apply(self, state: dict, x: torch.Tensor):
        tracer = tracing.local.tracer
        if tracer is None:
            return self._apply_stages(state, x, None)
        with tracing.chain_tick(tracer, x) as tick:  # a stamp at each stage boundary
            return self._apply_stages(state, x, tick)

    def _apply_stages(self, state: dict, x: torch.Tensor, tick):
        new_state = {}
        for name, b in self.blocks:
            new_state[name], x = b.apply(state[name], x)
            if tick is not None:
                tick.stamp(name)
        return new_state, x

    def out_len(self, in_len: int) -> int:
        n = in_len
        for _, b in self.blocks:
            n = b.out_len(n)
        return n

    def shift_state(self, state: dict, offset_samples: int) -> dict:
        """Per-block closed-form state shift; the input-sample offset (a
        Python int, a granule multiple) is rescaled through each stage."""
        o = int(offset_samples)
        new = {}
        for name, b in self.blocks:
            new[name] = b.shift_state(state[name], o)
            o = (o * b.up) // b.down
        return new

    def advance_state(self, state: dict, num_samples: int) -> dict:
        n = num_samples
        new = {}
        for name, b in self.blocks:
            new[name] = b.advance_state(state[name], n)
            n = n * b.up // b.down
        return new

    def split_shardable(self) -> tuple["Chain", "Chain | None"]:
        """(time-shardable prefix, sequential tail): blocks with unbounded
        memory land in the tail, which runs on the decimated stream."""
        blocks = self.blocks
        k = next((i for i, (_, b) in enumerate(blocks) if not b.time_shardable), len(blocks))
        return Chain(blocks[:k]), (Chain(blocks[k:]) if k < len(blocks) else None)

    def plan(self, in_len: int) -> list[tuple[str, int, int]]:
        """(name, in_len, out_len) per stage."""
        out = []
        n = in_len
        for name, b in self.blocks:
            m = b.out_len(n)
            out.append((name, n, m))
            n = m
        return out
