"""Host-side IQ sources (port of tpusdr/io/sources.py:53-314; numpy only).

Each source iterates over numpy blocks, the host side of the streaming
tick; the StreamRunner uploads them.

  * FileIqSource   — recorded capture playback from a memmap, read to EOF:
                     the last block may be shorter than the others, and
                     the runner zero-pads it to the chain's granule.
  * SocketIqSource — live IQ over TCP: a reader thread and a bounded queue
                     that drops blocks on overrun (the HackrfSource role).
  * SyntheticIqSource — deterministic test signal generator.
  * CallbackSource — adapt any callable.

Integer IQ travels as packed words, one per complex sample (an int8 pair
as an int16 word, an int16 pair as an int32 word): the same bytes as the
wire, viewed for free, so the stream's rate is one word per sample.
"""

from __future__ import annotations

import queue
import socket
import threading
from typing import Callable, Iterator

import numpy as np

from tpusdr_torch.utils.logging import get_logger

log = get_logger("io")

#: wire format -> element dtype of the blocks a source yields
_WORD_DTYPES = {
    "int8": np.int16,
    "int16": np.int32,
    "float32": np.float32,
    "cf32": np.complex64,
}

# queue sentinel: the reader's socket went silent (a clean EOF enqueues None)
_SILENT = object()


def _elements_per_block(block_samples: int, fmt: str) -> int:
    return 2 * block_samples if fmt == "float32" else block_samples


class FileIqSource:
    """Interleaved-IQ file playback, ``block_samples`` complex samples per
    block.  Integer formats yield packed words (one per complex sample);
    'float32' yields 2x interleaved scalars; 'cf32' yields complex64.

    Without ``loop`` the file is read to its end, and the last block holds
    whatever is left.  With ``loop`` the file repeats and every block is
    full, wrapping across the end."""

    def __init__(
        self,
        path: str,
        block_samples: int,
        input_format: str = "int8",
        loop: bool = False,
        max_blocks: int | None = None,
    ):
        self.path = path
        self.block = int(block_samples)
        self.format = input_format
        self.loop = loop
        self.max_blocks = max_blocks
        self._mm = np.memmap(path, dtype=_WORD_DTYPES[input_format], mode="r")
        self._n = _elements_per_block(self.block, input_format)

    def _blocks(self) -> Iterator[np.ndarray]:
        n, mm = self._n, self._mm
        if not self.loop:
            for i in range(0, len(mm), n):
                yield np.asarray(mm[i : i + n])
            return
        if len(mm) == 0:
            return
        pos = 0
        while True:
            idx = (pos + np.arange(n)) % len(mm)
            yield np.asarray(mm[idx])
            pos = (pos + n) % len(mm)

    def __iter__(self) -> Iterator[np.ndarray]:
        for i, b in enumerate(self._blocks()):
            if self.max_blocks is not None and i >= self.max_blocks:
                return
            yield b

    @property
    def num_blocks(self) -> int:
        """Blocks in one pass over the file, the short last one included."""
        return -(-len(self._mm) // self._n)


class SyntheticIqSource:
    """Deterministic signal generator for tests and benches: any
    ``make_block(t)`` (an FM-modulated carrier with ``fm``), emitted as
    complex64 blocks or in an integer wire format."""

    def __init__(
        self,
        block_samples: int,
        sample_rate: float,
        make_block: Callable[[np.ndarray], np.ndarray],
        output_format: str = "cf32",
        num_blocks: int | None = None,
    ):
        self.block = int(block_samples)
        self.fs = sample_rate
        self.make_block = make_block
        self.format = output_format
        self.num_blocks = num_blocks

    @staticmethod
    def fm(
        block_samples: int,
        sample_rate: float,
        audio_hz: float = 1000.0,
        deviation: float = 75e3,
        carrier_offset: float = 0.0,
        output_format: str = "cf32",
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

        return SyntheticIqSource(block_samples, sample_rate, make, output_format, num_blocks)

    @staticmethod
    def am(
        block_samples: int,
        sample_rate: float,
        carrier_offset: float = 0.0,
        output_format: str = "cf32",
        num_blocks: int | None = None,
        audio_hz: float = 700.0,
        depth: float = 0.5,
    ) -> "SyntheticIqSource":
        """The receive CLI's AM test signal: a carrier at ``carrier_offset``,
        amplitude 0.5, modulated ``depth`` by a tone at ``audio_hz``."""

        def make(t: np.ndarray) -> np.ndarray:
            carrier = 1.0 + depth * np.sin(2 * np.pi * audio_hz * t)
            return (0.5 * carrier * np.exp(2j * np.pi * carrier_offset * t)).astype(np.complex64)

        return SyntheticIqSource(block_samples, sample_rate, make, output_format, num_blocks)

    def __iter__(self) -> Iterator[np.ndarray]:
        i = 0
        emitted = 0
        while self.num_blocks is None or emitted < self.num_blocks:
            t = (np.arange(self.block) + i) / self.fs
            yield _format_iq(self.make_block(t), self.format)
            i += self.block
            emitted += 1


def _format_iq(z: np.ndarray, fmt: str) -> np.ndarray:
    """complex samples -> a wire format: complex64 ('cf32'), interleaved
    float32 ('float32'), or packed int8 / int16 words (full scale 127 /
    32767, rounded and clipped)."""
    if fmt == "cf32":
        return z.astype(np.complex64)
    inter = np.empty(2 * len(z), dtype=np.float32)
    inter[0::2] = z.real
    inter[1::2] = z.imag
    if fmt == "int8":
        return np.clip(np.round(inter * 127.0), -128, 127).astype(np.int8).view(np.int16)
    if fmt == "int16":
        return np.clip(np.round(inter * 32767.0), -32768, 32767).astype(np.int16).view(np.int32)
    return inter


class SocketIqSource:
    """Live IQ over a TCP socket with a bounded pool and drop-on-overrun
    (HackrfSource.cpp:175-201 with the USB callback replaced by a socket
    reader thread).  ``skip_until_byte`` drops blocks captured before a
    retune took effect."""

    def __init__(
        self,
        host: str,
        port: int,
        block_samples: int,
        input_format: str = "int8",
        pool_blocks: int = 3,
        timeout_s: float = 5.0,
    ):
        self.addr = (host, port)
        self.block = int(block_samples)
        self.format = input_format
        self._dtype = _WORD_DTYPES[input_format]
        self._itemsize = np.dtype(self._dtype).itemsize
        self._scalars = _elements_per_block(self.block, input_format)
        # items: (wire byte offset of the block's first byte, block)
        self._q: queue.Queue = queue.Queue(maxsize=pool_blocks)
        self.timeout_s = timeout_s
        self.dropped_blocks = 0
        self.flushed_blocks = 0
        self._skip_until = 0
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    def _reader(self, sock: socket.socket) -> None:
        nbytes = self._scalars * self._itemsize
        buf = b""
        framed = 0
        try:
            while not self._stop.is_set():
                while len(buf) < nbytes:
                    try:
                        chunk = sock.recv(1 << 16)
                    except TimeoutError as e:
                        log.warning("socket ingest reader timed out: %s", e)
                        self._q.put(_SILENT)
                        return
                    except OSError as e:
                        log.warning("socket ingest reader stopped: %s", e)
                        self._q.put(None)
                        return
                    if not chunk:
                        self._q.put(None)
                        return
                    buf += chunk
                block = np.frombuffer(buf[:nbytes], dtype=self._dtype).copy()
                buf = buf[nbytes:]
                start = framed
                framed += nbytes
                try:
                    self._q.put_nowait((start, block))
                except queue.Full:
                    self.dropped_blocks += 1
                    if self.dropped_blocks % 100 == 1:
                        log.warning("socket ingest overrun: dropped %d blocks", self.dropped_blocks)
        finally:
            sock.close()

    def skip_until_byte(self, wire_pos: int) -> None:
        """Discard every block holding wire bytes before ``wire_pos``."""
        self._skip_until = max(self._skip_until, int(wire_pos))

    def __iter__(self) -> Iterator[np.ndarray]:
        sock = socket.create_connection(self.addr, timeout=self.timeout_s)
        sock.settimeout(self.timeout_s)
        self._thread = threading.Thread(target=self._reader, args=(sock,), daemon=True)
        self._thread.start()
        while True:
            try:
                item = self._q.get(timeout=self.timeout_s)
            except queue.Empty:
                item = _SILENT
            if item is _SILENT:
                raise TimeoutError(f"no IQ data within {self.timeout_s}s")
            if item is None:
                return
            start, block = item
            if start < self._skip_until:
                self.flushed_blocks += 1
                continue
            yield block

    def close(self) -> None:
        self._stop.set()


class CallbackSource:
    """Wrap a callable ``f(block_index) -> np.ndarray | None`` as a source."""

    def __init__(self, fn: Callable[[int], np.ndarray | None]):
        self.fn = fn

    def __iter__(self) -> Iterator[np.ndarray]:
        i = 0
        while True:
            b = self.fn(i)
            if b is None:
                return
            yield b
            i += 1
