"""Channel-sharded multi-channel receiver (port of
tpusdr/parallel/channels.py).

Per streaming tick, over S shards of a mesh axis (a tuple of axes is one
flattened ring):

  1. the wideband input is time-sharded; each shard channelizes its time
     slice after an overlap-save halo (one ``shift_right``), cold, and
     drops the halo's frames: (M channels, F_local frames);
  2. one ``all_to_all`` pivots the tick from time-sharded frames to
     channel-sharded streams: each shard then holds the whole tick of
     m_pad/S channels (channels are padded with dead ones to a multiple of
     S; their audio is dropped);
  3. the demod chain runs on each shard's channels, whose state (the
     discriminator's last sample, the de-emphasis IIR, the resampler's
     tail) the shard owns and carries across ticks with no further
     exchange; the IIR is exact, since the whole time axis is local.

On a ``LocalMesh`` on the card the whole step is one captured CUDA graph
a tick, as in ``halo.py``.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils import _pytree as pytree

from tpusdr_torch.graph.blocks import Channelizer
from tpusdr_torch.graph.chain import Chain
from tpusdr_torch.graph.runner import CapturedStep
from tpusdr_torch.parallel.halo import _tail, resolve_capture
from tpusdr_torch.parallel.mesh import Axis, Mesh
from tpusdr_torch.utils.logging import get_logger
from tpusdr_torch.utils.numerics import round_up

log = get_logger("parallel")


def _rows(state, lo: int, hi: int):
    """The channels [lo, hi) of a demod state (0-d leaves are shared)."""
    return pytree.tree_map(lambda a: a[lo:hi] if a.dim() else a, state)


def _join_rows(states: list):
    """Per-shard demod states joined along the channel axis."""
    leaves = [pytree.tree_flatten(s)[0] for s in states]
    spec = pytree.tree_flatten(states[0])[1]
    return pytree.tree_unflatten(
        [torch.cat(ls) if ls[0].dim() else ls[0] for ls in zip(*leaves)], spec)


class ChannelShardedBank:
    """A channelizer and a per-channel demod chain over a mesh axis; both
    are moved to the mesh's device."""

    def __init__(self, channelizer: Channelizer, demod_chain: Chain, mesh: Mesh, axis: Axis = "dev",
                 capture: bool | None = None):
        self.mesh = mesh
        self.channelizer = channelizer.to(mesh.device)
        self.chan_chain = Chain([("channelizer", channelizer)])
        self.demod_chain = demod_chain.to(mesh.device)
        self.axis = axis if isinstance(axis, str) or len(axis) > 1 else axis[0]
        self.shards = mesh.size(axis)
        self.m = channelizer.num_channels
        self.m_pad = round_up(self.m, self.shards)
        self.local_channels = self.m_pad // self.shards
        self.halo = round_up(max(self.chan_chain.history, 1), self.chan_chain.granule)
        self.skip = self.halo // self.m  # channelizer frames to drop
        self.capture = resolve_capture(mesh, capture)
        self._step_cache: dict[int, Callable] = {}
        log.info("channel bank: %d channels (%d padded) / %d shards (%d local), halo %d",
                 self.m, self.m_pad, self.shards, self.local_channels, self.halo)

    def init_carry(self) -> dict:
        """The halo tail and the demod state of this process's channels:
        (m_pad, ...) on a LocalMesh, a rank's share on a DistMesh."""
        owned = self.local_channels * len(self.mesh.local_shards(self.axis))
        return {
            "tail": torch.zeros(self.halo, dtype=torch.complex64, device=self.mesh.device),
            "demod_state": self.demod_chain.init_state((owned,), device=self.mesh.device),
        }

    def apply(self, carry: dict, x: torch.Tensor):
        """The eager step (``step`` captures it on the card)."""
        per_shard = self._per_shard(x)
        idxs = self.mesh.local_shards(self.axis)
        parts = list(x.split(per_shard, dim=-1))
        left = self.mesh.shift_right([_tail(p, self.halo) for p in parts])
        frames = []
        for i, p, lt in zip(idxs, parts, left):
            ext = torch.cat([carry["tail"] if i == 0 else lt, p], dim=-1)
            _, y_ext = self.chan_chain.apply(self.chan_chain.init_state(device=ext.device), ext)
            y = y_ext[..., self.skip :]
            if self.m_pad != self.m:
                y = torch.cat([y, y.new_zeros((self.m_pad - self.m, y.shape[-1]))])
            frames.append(y)
        # time-sharded frames -> the whole tick of each shard's channels
        streams = self.mesh.all_to_all(frames, split_axis=0, concat_axis=1)
        lc, states, audio = self.local_channels, [], []
        for k, y_full in enumerate(streams):
            s, a = self.demod_chain.apply(_rows(carry["demod_state"], k * lc, (k + 1) * lc), y_full)
            states.append(s)
            audio.append(a)
        new_carry = {"tail": left[0].clone(), "demod_state": _join_rows(states)}
        return new_carry, self.mesh.gather(audio, dim=0)[: self.m]

    def _per_shard(self, x: torch.Tensor) -> int:
        local = len(self.mesh.local_shards(self.axis))
        n = x.shape[-1] * (self.shards // local)
        gran = self.shards * self.chan_chain.granule
        if n % gran:
            raise ValueError(f"tick {n} must be divisible by {gran}")
        per_shard = n // self.shards
        if per_shard < self.halo:
            raise ValueError(f"per-shard {per_shard} < halo {self.halo}")
        return per_shard

    def step(self, carry: dict, x: torch.Tensor):
        """One tick: ``x`` the wideband complex64 input on the mesh's
        device (the global tick on a LocalMesh, this rank's part on a
        DistMesh).  Returns (carry', audio), audio (num_channels, n_audio)
        on every process, dead channels dropped."""
        per_shard = self._per_shard(x)
        if per_shard not in self._step_cache:
            self._step_cache[per_shard] = CapturedStep(self) if self.capture else self.apply
        return self._step_cache[per_shard](carry, x)
