"""The Block protocol: a streaming operator as an ``nn.Module``.

Port of tpusdr/graph/block.py.  The whole contract is

  * ``apply(state, x) -> (state', y)`` — one streaming step;
  * a rational rate ratio ``(up, down)`` — out_len = in_len * up / down;
  * ``history`` — input-rate lookback samples;
  * ``init_state(batch_shape, device)`` — the explicit carry.

Taps and other constants are registered buffers, so ``block.to(device)``
moves them; the carry lives outside the module and is created on the
device the caller names.  No block picks a device by itself.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import torch
from torch import nn

State = Any


class Block(nn.Module):
    """Base streaming operator. Subclasses set rate/dtype attributes."""

    n_inputs: int = 1
    up: int = 1
    down: int = 1
    history: int = 0
    adds_channel_axis: bool = False
    num_channels: int = 1
    in_dtype = torch.complex64
    out_dtype = torch.complex64
    time_shardable: bool = True

    def init_state(self, batch_shape: Sequence[int] = (), device=None) -> State:
        return ()

    def apply(self, state: State, x: torch.Tensor) -> tuple[State, torch.Tensor]:
        raise NotImplementedError

    def forward(self, state: State, x: torch.Tensor) -> tuple[State, torch.Tensor]:
        return self.apply(state, x)

    # Closed-form states (NCO phase) override these with exact modular
    # arithmetic; carries that are "the last L samples" are left unchanged.

    def shift_state(self, state: State, offset_samples: int) -> State:
        """State as it would be ``offset_samples`` later in the stream."""
        return state

    def advance_state(self, state: State, num_samples: int) -> State:
        """Exact advance of closed-form state by a sample count."""
        return state

    def out_len(self, in_len: int) -> int:
        if (in_len * self.up) % self.down != 0:
            raise ValueError(
                f"{self.__class__.__name__}: input length {in_len} is not "
                f"compatible with rate {self.up}/{self.down}"
            )
        return in_len * self.up // self.down

    @property
    def granule(self) -> int:
        """Smallest input length quantum this block accepts."""
        return self.down // math.gcd(self.up, self.down)

    def extra_repr(self) -> str:
        return f"up={self.up}, down={self.down}, history={self.history}"
