"""Host-side synthetic IQ source (port of the ``SyntheticIqSource`` of
tpusdr/io/sources.py:98-170; numpy only), complex64 output only.  The
other sources and the integer wire formats wait for a later slice
(ROADMAP.md)."""

from __future__ import annotations

from typing import Callable, Iterator

import numpy as np


class SyntheticIqSource:
    """Deterministic signal generator for tests/benches: an FM-modulated
    carrier (or any ``make_block(t)``), emitted as complex64 blocks."""

    def __init__(
        self,
        block_samples: int,
        sample_rate: float,
        make_block: Callable[[np.ndarray], np.ndarray],
        num_blocks: int | None = None,
    ):
        self.block = int(block_samples)
        self.fs = sample_rate
        self.make_block = make_block
        self.num_blocks = num_blocks

    @staticmethod
    def fm(
        block_samples: int,
        sample_rate: float,
        audio_hz: float = 1000.0,
        deviation: float = 75e3,
        carrier_offset: float = 0.0,
        num_blocks: int | None = None,
        amplitude: float = 0.9,
    ) -> "SyntheticIqSource":
        """FM-modulated tone at ``carrier_offset`` from centre.  The
        modulation phase restarts each block, so pick blocks that hold whole
        audio periods (or one block for the whole signal)."""

        def make(t: np.ndarray) -> np.ndarray:
            audio = np.sin(2 * np.pi * audio_hz * t)
            phase = (
                2 * np.pi * carrier_offset * t
                + 2 * np.pi * deviation * np.cumsum(audio) / sample_rate
            )
            return (amplitude * np.exp(1j * phase)).astype(np.complex64)

        return SyntheticIqSource(block_samples, sample_rate, make, num_blocks)

    def __iter__(self) -> Iterator[np.ndarray]:
        i = 0
        emitted = 0
        while self.num_blocks is None or emitted < self.num_blocks:
            t = (np.arange(self.block) + i) / self.fs
            yield self.make_block(t).astype(np.complex64)
            i += self.block
            emitted += 1
