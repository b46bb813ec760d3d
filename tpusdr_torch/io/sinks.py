"""Host-side stream sinks (port of tpusdr/io/sinks.py; numpy only).

The reference's audio endpoint is AacFileWriter (an FFmpeg AAC encoder);
``AacFileSink`` keeps its semantics — container by extension,
frame-granular commits, flush on close — through an ffmpeg subprocess.
The WAV, raw, collecting and counting sinks are native.  A sink takes
numpy arrays: the runner copies each output to the host first.
"""

from __future__ import annotations

import subprocess
import wave
from typing import List

import numpy as np


class WavSink:
    """Stream float32 PCM in [-1, 1] to a 16-bit WAV file."""

    def __init__(self, path: str, sample_rate: float, channels: int = 1):
        self.path = path
        self._wav = wave.open(path, "wb")
        self._wav.setnchannels(channels)
        self._wav.setsampwidth(2)
        self._wav.setframerate(int(round(sample_rate)))
        self.samples_written = 0

    def write(self, pcm: np.ndarray) -> None:
        x = np.asarray(pcm, dtype=np.float32)
        i16 = np.clip(np.round(x * 32767.0), -32768, 32767).astype("<i2")
        self._wav.writeframes(i16.tobytes())
        self.samples_written += x.shape[-1]

    def close(self) -> None:
        self._wav.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class AacFileSink:
    """Compressed-audio sink via an ffmpeg subprocess.

    Reference parity: AacFileWriter (src/filters/AacFileWriter.cpp):
      * container/muxer chosen from the output extension by ffmpeg itself
        (.aac/.ts/.m4a ... — avformat_alloc_output_context2 role, :93-101);
      * **frame-granular commits** (:267-299): PCM is buffered and handed to
        the encoder only in whole ``frame_size`` frames, mirroring the
        writer's "exclude in-flight bytes, encode full frames" loop;
      * **flush on close** (:248-261): the partial tail frame and the
        encoder's delayed packets are drained when the sink closes.

    The subprocess is the process boundary the reference gets from linking
    libavcodec; stderr is captured and surfaced on failure.  Raises
    FileNotFoundError at construction when ffmpeg is not installed.
    """

    FRAME = 1024  # AAC encoder frame size (samples/channel)

    def __init__(
        self,
        path: str,
        sample_rate: float,
        channels: int = 1,
        bitrate: int = 128_000,
        codec: str = "aac",
        ffmpeg: str = "ffmpeg",
        _popen=subprocess.Popen,  # injectable for tests
    ):
        self.path = path
        self.channels = int(channels)
        args = [
            ffmpeg,
            "-y",
            "-loglevel",
            "error",
            "-f",
            "f32le",
            "-ar",
            str(int(round(sample_rate))),
            "-ac",
            str(self.channels),
            "-i",
            "pipe:0",
            "-c:a",
            codec,
            "-b:a",
            str(int(bitrate)),
            path,
        ]
        self._proc = _popen(
            args,
            stdin=subprocess.PIPE,
            stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE,
        )
        self._buf = np.empty((0,), np.float32)
        self.samples_written = 0
        self._closed = False

    def write(self, pcm: np.ndarray) -> None:
        x = np.asarray(pcm, dtype=np.float32).reshape(-1)
        self.samples_written += x.shape[-1] // self.channels
        buf = np.concatenate([self._buf, x])
        granule = AacFileSink.FRAME * self.channels
        full = (buf.shape[-1] // granule) * granule
        if full:
            self._send(buf[:full])
        self._buf = buf[full:]

    def _send(self, x: np.ndarray) -> None:
        try:
            self._proc.stdin.write(np.ascontiguousarray(x, np.float32).tobytes())
        except BrokenPipeError:
            self._raise_encoder_error()

    def _raise_encoder_error(self) -> None:
        err = self._proc.stderr.read() if self._proc.stderr else b""
        raise RuntimeError(
            f"ffmpeg encoder exited (rc={self._proc.poll()}): "
            f"{err.decode(errors='replace').strip()}"
        )

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._buf.size:  # flush the partial tail frame (:248-261)
            self._send(self._buf)
            self._buf = np.empty((0,), np.float32)
        self._proc.stdin.close()
        rc = self._proc.wait()
        if rc != 0:
            self._raise_encoder_error()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RawFileSink:
    """Raw binary dump of each block (any dtype)."""

    def __init__(self, path: str, dtype=np.float32):
        self.path = path
        self.dtype = np.dtype(dtype)
        self._f = open(path, "wb")
        self.samples_written = 0

    def write(self, x: np.ndarray) -> None:
        arr = np.ascontiguousarray(np.asarray(x), dtype=self.dtype)
        self._f.write(arr.tobytes())
        self.samples_written += arr.shape[-1]

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class CollectSink:
    """Accumulate blocks in memory (tests, benches)."""

    def __init__(self):
        self.blocks: List[np.ndarray] = []
        self.samples_written = 0

    def write(self, x: np.ndarray) -> None:
        arr = np.asarray(x)
        self.blocks.append(arr)
        self.samples_written += arr.shape[-1]

    def result(self, axis: int = -1) -> np.ndarray:
        return np.concatenate(self.blocks, axis=axis)

    def close(self) -> None:
        pass


class NullSink:
    """Discard output, count samples (the ReadByteCountMonitor role,
    ReadByteCountMonitor.cpp:44-63)."""

    def __init__(self):
        self.samples_written = 0

    def write(self, x: np.ndarray) -> None:
        self.samples_written += np.asarray(x).shape[-1]

    def close(self) -> None:
        pass
