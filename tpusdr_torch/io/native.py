"""ctypes bindings for the port's host runtime (csrc/host_ring.cpp; port of
tpusdr/io/native.py).

A single-producer, single-consumer byte ring, a file reader thread that
fills it (capture playback read ahead, off the Python GIL: the role of the
reference's C++ BufferPool and FileReader, SURVEY.md section 2.3) and
float32 PCM -> int16.  The library is built at first use with the host
C++ compiler (``$CXX``, else ``c++``) into ``build/tpusdr_torch/``, named
by a hash of its source and flags; a failed build raises.  There is no
NumPy fallback: without the library the classes and ``f32_to_i16`` raise.
``f32_to_i16_plain`` is the same arithmetic in NumPy, for the tests.

``NativeFileStream`` yields the port's block contract, that of
``io.sources.FileIqSource``: int8 IQ as int16 packed words, int16 IQ as
int32 words, cf32 as complex64, the short last block included.  The words
go to the card as they are and convert there (``IqToComplex``), so the
JAX module's host deinterleave (``deinterleave_to_planes``) has no
counterpart.

    python -m tpusdr_torch.io.native --build
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from tpusdr_torch.io.sources import _WORD_DTYPES
from tpusdr_torch.utils.logging import get_logger

log = get_logger("io.native")

SOURCE = Path(__file__).resolve().parent / "csrc" / "host_ring.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpusdr_torch"
# -ffp-contract=off: f32_to_i16 must round as the JAX library's C form does
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared", "-ffp-contract=off")
FILE_CHUNK = 64 << 10  # the file reader's largest piece (FileReader.cpp:48-66)

_lib: ctypes.CDLL | None = None


def build() -> Path:
    """Compile ``csrc/host_ring.cpp`` into the shared library (if not built
    yet); raises ``RuntimeError`` if the compiler fails or is missing."""
    cxx = os.environ.get("CXX") or "c++"
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join((cxx, *CXX_FLAGS)).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libtpusdr_host_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        raise RuntimeError(f"host build failed: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"host build failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}")
    os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded host library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, n, i = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int
        lib.tpusdr_host_ring_create.argtypes = [n]
        lib.tpusdr_host_ring_create.restype = p
        lib.tpusdr_host_ring_destroy.argtypes = [p]
        lib.tpusdr_host_ring_destroy.restype = None
        lib.tpusdr_host_ring_available.argtypes = [p]
        lib.tpusdr_host_ring_available.restype = n
        lib.tpusdr_host_ring_dropped.argtypes = [p]
        lib.tpusdr_host_ring_dropped.restype = ctypes.c_uint64
        lib.tpusdr_host_ring_close.argtypes = [p]
        lib.tpusdr_host_ring_close.restype = None
        lib.tpusdr_host_ring_write.argtypes = [p, p, n]
        lib.tpusdr_host_ring_write.restype = n
        lib.tpusdr_host_ring_write_wait.argtypes = [p, p, n, i]
        lib.tpusdr_host_ring_write_wait.restype = n
        lib.tpusdr_host_ring_read.argtypes = [p, p, n, i]
        lib.tpusdr_host_ring_read.restype = ctypes.c_int64
        lib.tpusdr_host_file_reader_start.argtypes = [ctypes.c_char_p, p, n, i]
        lib.tpusdr_host_file_reader_start.restype = p
        lib.tpusdr_host_file_reader_stop.argtypes = [p]
        lib.tpusdr_host_file_reader_stop.restype = None
        lib.tpusdr_host_f32_to_i16.argtypes = [p, p, n]
        lib.tpusdr_host_f32_to_i16.restype = None
        _lib = lib
        log.debug("host library loaded from %s", lib._name)
    return _lib


def native_available() -> bool:
    """Whether the host library builds and loads here."""
    try:
        get_lib()
    except (RuntimeError, OSError) as e:
        log.warning("host library unavailable: %s", e)
        return False
    return True


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


class NativeRing:
    """SPSC byte ring: drop-on-overrun writes, blocking reads; after
    ``close`` a read returns what is left."""

    def __init__(self, capacity_bytes: int):
        if capacity_bytes <= 0:
            raise ValueError(f"ring capacity must be positive, got {capacity_bytes}")
        self._lib = get_lib()
        self._h = self._lib.tpusdr_host_ring_create(int(capacity_bytes))
        if not self._h:
            raise MemoryError(f"ring allocation of {capacity_bytes} bytes failed")
        self.capacity = int(capacity_bytes)

    def write(self, data: np.ndarray) -> bool:
        """All of ``data`` or nothing; False (and a drop counted) if it
        does not fit, False (no drop) once closed."""
        buf = np.ascontiguousarray(data)
        return self._lib.tpusdr_host_ring_write(self._h, _ptr(buf), buf.nbytes) == buf.nbytes

    def read(self, nbytes: int, dtype=np.uint8, timeout_ms: int = 5000) -> np.ndarray | None:
        """``nbytes`` as an array of ``dtype``, waiting up to ``timeout_ms``;
        None at the timeout.  After ``close``, what is left in whole
        elements (an empty array at the end)."""
        itemsize = np.dtype(dtype).itemsize
        if nbytes % itemsize or nbytes > self.capacity:
            raise ValueError(f"read of {nbytes} bytes: not whole {np.dtype(dtype)} or over the capacity {self.capacity}")
        out = np.empty(nbytes // itemsize, dtype=dtype)
        got = self._lib.tpusdr_host_ring_read(self._h, _ptr(out), nbytes, int(timeout_ms))
        if got < 0:
            return None
        return out[: got // itemsize]

    @property
    def available(self) -> int:
        return self._lib.tpusdr_host_ring_available(self._h)

    @property
    def dropped(self) -> int:
        return self._lib.tpusdr_host_ring_dropped(self._h)

    def close(self) -> None:
        """No more writes; readers drain what is left."""
        self._lib.tpusdr_host_ring_close(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.tpusdr_host_ring_destroy(self._h)
            self._h = None


class NativeFileStream:
    """Capture playback read ahead by a native thread through a ring of
    ``ring_blocks`` blocks; iterates over blocks of ``block_samples``
    complex samples in the port's word dtypes, the short last block
    included (``loop`` repeats the file, every block full).  A block that
    does not arrive within ``timeout_ms`` raises ``TimeoutError``.

    ``close`` (or leaving the ``with`` block) closes the ring and joins
    the reader thread; a read waiting on another thread then returns.
    The ring's memory goes with the last reference to it, so never under
    the reader or a read."""

    def __init__(
        self,
        path: str,
        block_samples: int,
        input_format: str = "int8",
        ring_blocks: int = 8,
        loop: bool = False,
        timeout_ms: int = 5000,
    ):
        if input_format not in ("int8", "int16", "cf32"):
            raise ValueError(f"unknown input format {input_format!r}")
        self.dtype = _WORD_DTYPES[input_format]
        self.block_bytes = int(block_samples) * np.dtype(self.dtype).itemsize
        self.timeout_ms = timeout_ms
        self._fr = None
        self.ring = NativeRing(self.block_bytes * ring_blocks)
        lib = self.ring._lib
        self._fr = lib.tpusdr_host_file_reader_start(os.fsencode(path), self.ring._h, FILE_CHUNK, int(loop))
        if not self._fr:
            raise FileNotFoundError(path)

    def __iter__(self):
        while True:
            blk = self.ring.read(self.block_bytes, self.dtype, self.timeout_ms)
            if blk is None:
                raise TimeoutError(f"no IQ block within {self.timeout_ms} ms")
            if len(blk):
                yield blk
            if len(blk) * blk.itemsize < self.block_bytes:
                return

    def close(self) -> None:
        if self._fr:
            self.ring._lib.tpusdr_host_file_reader_stop(self._fr)
            self._fr = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        if getattr(self, "_fr", None):
            self.close()


def f32_to_i16(x: np.ndarray) -> np.ndarray:
    """float32 PCM in [-1, 1] -> int16: x 32767, clamped, rounded half away
    from zero, in the host library."""
    lib = get_lib()
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty(x.shape, np.int16)
    lib.tpusdr_host_f32_to_i16(_ptr(x), _ptr(out), x.size)
    return out


def f32_to_i16_plain(x: np.ndarray) -> np.ndarray:
    """``f32_to_i16``'s arithmetic in NumPy, step for step in float32 (the
    tests' reference)."""
    v = np.clip(np.asarray(x, np.float32) * np.float32(32767.0), np.float32(-32768.0), np.float32(32767.0))
    half = np.where(v >= 0, np.float32(0.5), np.float32(-0.5))
    return np.trunc(v + half).astype(np.int16)


if __name__ == "__main__":
    if "--build" in sys.argv:
        print("host library:", build())
        sys.exit(0)
    print("host library available:", native_available())
