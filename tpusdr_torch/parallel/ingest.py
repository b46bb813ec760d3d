"""Sharded IQ ingest (port of tpusdr/parallel/ingest.py).

With several processes there is no single reader: each process loads
exactly its shards of each global tick.  The global tick index is the one
source of truth.  Process p of P, owning the mesh's shards [p*L, (p+1)*L),
reads the byte range ``tick_index * tick_bytes + p * local_bytes`` of its
copy of the capture (or of its own segment of it), and hands its part to
the sharded stream, which takes a rank's part on a ``DistMesh``.  A
single process (a ``LocalMesh``) takes the same path with P = 1.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from tpusdr_torch.parallel.mesh import Axis, Mesh
from tpusdr_torch.utils.logging import get_logger

log = get_logger("parallel.ingest")

_DTYPES = {"int8": np.int8, "int16": np.int16, "cf32": np.complex64}


class ShardedFileIngest:
    """Per-process reader of a (replicated or pre-split) IQ capture that
    yields this process's part of each global tick.

    Args:
      path: the capture file this process sees: the whole capture
        (replicated) or this process's contiguous segment (pre-split,
        ``segment_of_host=True``).
      mesh / axis: the mesh and the time-sharding axis.
      tick_samples: complex samples a global tick (divisible by the shards).
      input_format: 'int8' | 'int16' | 'cf32' (interleaved I/Q for ints).
    """

    def __init__(self, path: str, mesh: Mesh, tick_samples: int, axis: Axis = "dev",
                 input_format: str = "cf32", segment_of_host: bool = False):
        self.mesh = mesh
        self.axis = axis
        self.shards = mesh.size(axis)
        if tick_samples % self.shards:
            raise ValueError(f"tick {tick_samples} not divisible by {self.shards} shards")
        self.tick = tick_samples
        self.per_shard = tick_samples // self.shards
        self.format = input_format
        self._mm = np.memmap(path, dtype=_DTYPES[input_format], mode="r")
        self._scalars_per_sample = 1 if input_format == "cf32" else 2
        self.segment_of_host = segment_of_host
        self.process_index = mesh.rank
        self.num_processes = mesh.world_size
        self.shards_per_process = len(mesh.local_shards(axis))

    @property
    def num_ticks(self) -> int:
        total = len(self._mm) // self._scalars_per_sample
        if self.segment_of_host:
            total *= self.num_processes
        return total // self.tick

    def _local_block(self, tick_index: int) -> np.ndarray:
        """This process's contiguous samples of the given global tick."""
        sps_ = self._scalars_per_sample
        local_samples = self.per_shard * self.shards_per_process
        if self.segment_of_host:
            # the file holds only this process's stripe, tick-major
            start = tick_index * local_samples * sps_
        else:
            start = (tick_index * self.tick + self.process_index * local_samples) * sps_
        raw = np.array(self._mm[start : start + local_samples * sps_])  # a copy: the map is read-only
        if self.format == "cf32":
            return raw
        scale = 1.0 / 128.0 if self.format == "int8" else 1.0 / 32768.0
        f = raw.astype(np.float32) * scale
        return (f[0::2] + 1j * f[1::2]).astype(np.complex64)

    def ticks(self) -> Iterator[torch.Tensor]:
        """complex64 tensors on the mesh's device, one a tick: the global
        tick on a LocalMesh, this process's part on a DistMesh."""
        for i in range(self.num_ticks):
            yield torch.from_numpy(self._local_block(i)).to(self.mesh.device)
