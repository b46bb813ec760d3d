"""Time-block sharding with overlap-save halos (port of
tpusdr/parallel/halo.py).

A streaming tick of N input samples is split into S contiguous shards of
a mesh axis.  Each shard needs the last H input samples of its left
neighbour to continue every filter in the chain: H is the chain's
input-rate lookback (``Chain.history``, ``Graph.history``), rounded up to
the chain's granule so that every stage's decimation grid stays aligned
with the unsharded run.  Per tick:

  1. each shard's last H samples move one shard right (``Mesh.shift_right``);
     shard 0 takes the halo carried from the last tick instead;
  2. the chain runs cold on [halo, shard]: the halo warms every finite
     carry up to its streaming value (the overlap-save trick), so the
     carried state's FIR and demod history is never written, only its
     closed-form parts advanced;
  3. closed-form states (NCO phases) are set exactly by ``shift_state``
     with the shard's offset, which is negative for shard 0 (uint32
     arithmetic, ``ops/osc.py``);
  4. the halo's H*up/down outputs are dropped.

Stages with unbounded memory (an IIR beyond its warm-up limit) are split
off by ``split_shardable`` and run on the gathered output.  The stagewise
form exchanges one halo a stage, each at the stage's own input rate.

Sharded output equals unsharded output within float32 reassociation: the
windows, phases and reductions are the same, but a kernel or a plain op
may pick another blocking for a shard's length (tests hold it below -100
dB, as the JAX tests do).

On a ``LocalMesh`` on the card the whole step (S shards, the gather and
the sequential tail) is one captured CUDA graph a tick
(``graph.runner.CapturedStep``, one a per-shard length, as JAX keeps one
jitted step a per-shard length).  A ``DistMesh`` step is eager.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from tpusdr_torch.graph.chain import Chain
from tpusdr_torch.graph.runner import CapturedStep
from tpusdr_torch.parallel.mesh import Axis, LocalMesh, Mesh
from tpusdr_torch.utils.logging import get_logger
from tpusdr_torch.utils.numerics import lcm, round_up

log = get_logger("parallel")


def _tail(x: torch.Tensor, h: int) -> torch.Tensor:
    return x[..., x.shape[-1] - h :]


def resolve_capture(mesh: Mesh, capture: bool | None) -> bool:
    """None: capture on a ``LocalMesh`` on the card, eager elsewhere; True
    anywhere else raises ``ValueError`` (as ``StreamRunner`` does on the
    CPU)."""
    can = isinstance(mesh, LocalMesh) and mesh.device.type == "cuda"
    if capture and not can:
        raise ValueError(f"capture=True needs a LocalMesh on a CUDA device, not {mesh!r}")
    return can if capture is None else bool(capture)


class TimeShardedStream:
    """Run a Chain or a (single-input, single-output) Graph with its
    streaming tick sharded over a mesh axis.  The chain is moved to the
    mesh's device."""

    def __init__(self, chain, mesh: Mesh, axis: Axis = "dev", halo: int | None = None,
                 stagewise: bool | str = "auto", capture: bool | None = None):
        """``stagewise``: one halo a stage, at the stage's own input rate,
        instead of one chain-wide halo at the input rate ('auto': stagewise
        for a Chain, chain-wide for a Graph, which has no stage list).  A
        decimated stage's lookback then costs its own rate: the WBFM
        de-emphasis warm-up is about 500 samples at the quadrature rate,
        which the chain-wide halo inflates to 40,000 input samples at 20
        Msps.  ``capture``: see ``resolve_capture``."""
        self.mesh = mesh
        self.full_chain = chain.to(mesh.device)
        self.chain, self.tail_chain = chain.split_shardable()
        if isinstance(self.chain, Chain) and not self.chain.blocks:
            raise ValueError("chain has no time-shardable prefix")
        if stagewise == "auto":
            stagewise = isinstance(self.chain, Chain)
        self.stagewise = bool(stagewise)
        if self.stagewise and not isinstance(self.chain, Chain):
            raise ValueError("stagewise halos need a Chain (per-stage plan)")
        self.axis = axis if isinstance(axis, str) or len(axis) > 1 else axis[0]
        self.shards = mesh.size(axis)
        h = halo if halo is not None else self.chain.history
        self.halo = round_up(max(h, 1), self.chain.granule)
        self.skip = self.halo * self.chain.up // self.chain.down  # the halo's outputs
        if self.stagewise:
            # (name, block, h_pad, skip, batch_shape): h_pad is the stage's
            # warm-up halo in its own input samples, rounded to its granule
            # so that the dropped output count h_pad*up/down is exact
            self._stages = []
            bshape: tuple[int, ...] = ()
            for name, b in self.chain.blocks:
                g = max(b.granule, 1)
                h_pad = round_up(b.history, g) if b.history > 0 else 0
                self._stages.append((name, b, h_pad, h_pad * b.up // b.down, bshape))
                if b.adds_channel_axis:
                    bshape = bshape + (b.num_channels,)
        # a tick clears shards x the head's granule (halo alignment) and the
        # whole chain's granule (the sequential tail's own needs)
        self.tick_granule = lcm(self.shards * self.chain.granule, chain.granule)
        self.capture = resolve_capture(mesh, capture)
        self._step_cache: dict[int, Callable] = {}
        log.info("time sharding: %d shards on %r, halo %d samples, skip %d",
                 self.shards, axis, self.halo, self.skip)

    # -- carries ------------------------------------------------------------

    def init_carry(self) -> dict:
        dev = self.mesh.device
        carry = {
            "state": self.chain.init_state(device=dev),
            "tail": self._zero_tails() if self.stagewise else self._zeros((), self.chain.in_dtype, self.halo),
        }
        if self.tail_chain is not None:
            batch = (self.chain.num_channels,) if self.chain.adds_channel_axis else ()
            carry["tail_state"] = self.tail_chain.init_state(batch, device=dev)
        return carry

    def _zeros(self, batch: tuple, dtype, n: int) -> torch.Tensor:
        return torch.zeros(batch + (n,), dtype=dtype, device=self.mesh.device)

    def _zero_tails(self) -> dict:
        """One zero halo a stage with a lookback: in the stage's input
        dtype and rate, with the channel axes of the stages before it."""
        return {name: self._zeros(bshape, b.in_dtype, h_pad)
                for name, b, h_pad, _skip, bshape in self._stages if h_pad > 0}

    # -- the sharded step ---------------------------------------------------

    def _stage_lengths(self, per_shard: int) -> list[int]:
        """Each stage's per-shard input length; refuses a shard shorter
        than a stage's halo."""
        n_k = [per_shard]
        for _, b, _, _, _ in self._stages[:-1]:
            n_k.append(b.out_len(n_k[-1]))
        for (name, _b, h_pad, _s, _bs), n in zip(self._stages, n_k):
            if h_pad > n:
                raise ValueError(f"stage {name!r}: per-shard input {n} smaller than its halo {h_pad}; "
                                 "use a longer tick or fewer shards")
        return n_k

    def _shards_chainwide(self, carry_tail, state, parts, idxs, per_shard):
        halo, skip = self.halo, self.skip
        left = self.mesh.shift_right([_tail(p, halo) for p in parts])
        ys = []
        for i, p, lt in zip(idxs, parts, left):
            ext = torch.cat([carry_tail if i == 0 else lt, p], dim=-1)
            local_state = self.chain.shift_state(state, i * per_shard - halo)
            _, y_ext = self.chain.apply(local_state, ext)
            ys.append(y_ext[..., skip:])
        # on the rank of shard 0 the ring's wrap is the last shard's tail:
        # the next tick's shard-0 halo (other ranks never read it)
        return ys, left[0].clone()

    def _shards_stagewise(self, carry_tails, state, parts, idxs, per_shard):
        cur = parts
        tails = {}
        for (name, b, h_pad, skip, _bs), n in zip(self._stages, self._stage_lengths(per_shard)):
            states = [b.shift_state(state[name], i * n - h_pad) for i in idxs]
            if h_pad == 0:
                cur = [b.apply(s, c)[1] for s, c in zip(states, cur)]
                continue
            left = self.mesh.shift_right([_tail(c, h_pad) for c in cur])
            cur = [b.apply(s, torch.cat([carry_tails[name] if i == 0 else lt, c], dim=-1))[1][..., skip:]
                   for i, s, c, lt in zip(idxs, states, cur, left)]
            tails[name] = left[0].clone()
        return cur, tails

    def apply(self, carry: dict, x: torch.Tensor) -> tuple[dict, Any]:
        """The eager sharded step (``step`` captures it on the card)."""
        n, per_shard = self._lengths(x)
        idxs = self.mesh.local_shards(self.axis)
        parts = list(x.split(per_shard, dim=-1))
        shards = self._shards_stagewise if self.stagewise else self._shards_chainwide
        ys, tails = shards(carry["tail"], carry["state"], parts, idxs, per_shard)
        y = self.mesh.gather(ys, dim=-1)
        new_carry = dict(carry)
        new_carry["tail"] = tails
        new_carry["state"] = self.chain.advance_state(carry["state"], n)
        if self.tail_chain is not None:
            new_carry["tail_state"], y = self.tail_chain.apply(carry["tail_state"], y)
        return new_carry, y

    def _lengths(self, x: torch.Tensor) -> tuple[int, int]:
        """(global tick length, per-shard length) of ``x``: the global tick
        on a LocalMesh, this rank's consecutive shards on a DistMesh."""
        local = len(self.mesh.local_shards(self.axis))
        n = x.shape[-1] * (self.shards // local)
        if n % self.tick_granule:
            raise ValueError(f"tick {n} must be divisible by tick_granule = {self.tick_granule}")
        per_shard = n // self.shards
        if per_shard < self.halo:
            raise ValueError(f"per-shard length {per_shard} smaller than halo {self.halo}")
        return n, per_shard

    # -- public api ---------------------------------------------------------

    def step(self, carry: dict, x: torch.Tensor) -> tuple[dict, Any]:
        """One sharded streaming tick.

        ``x``: the tick's input (last axis time) on the mesh's device: the
        global tick on a LocalMesh, this rank's part (its shards, in order)
        on a DistMesh, as ``ShardedFileIngest`` yields them.  Returns
        (carry', y), y the whole tick's output on every process.  A
        captured step returns its graph's static buffers: they hold until
        the next step, and are read on the step's stream."""
        _, per_shard = self._lengths(x)
        if per_shard not in self._step_cache:
            if self.stagewise:
                self._stage_lengths(per_shard)
            self._step_cache[per_shard] = CapturedStep(self) if self.capture else self.apply
        return self._step_cache[per_shard](carry, x)
