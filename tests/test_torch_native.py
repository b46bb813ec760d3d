"""The port's host runtime (tpusdr_torch/io/native.py, csrc/host_ring.cpp)
against the JAX package's (tpusdr/io/native.py over native/).

The ring cases of tests/test_native.py, capture playback byte for byte
against JAX's NativeFileStream, and the JAX faults the port does not copy,
each shown on the JAX side:

  * fault 2: JAX's stream drops a file's tail shorter than a block;
  * fault 3: JAX's reader writes 64 KiB pieces, which never fit a ring
    under 64 KiB, so such a stream yields nothing until its read timeout;
  * fault 13: JAX's f32_to_i16 rounds ties half away from zero in C and
    half to even in its NumPy fallback.

Every wait has its own bound (a read ``timeout_ms`` or a ``join``
timeout): the suite has no global test timeout.
"""

import threading
import time

import numpy as np
import pytest
import torch

from tpusdr.io import native as jn
from tpusdr_torch.apps import receive as treceive
from tpusdr_torch.io import native as tn
from tpusdr_torch.io.sources import FileIqSource

torch.set_num_threads(1)

JAX_BLOCK = {"int8": (np.int8, 2), "int16": (np.int16, 2), "cf32": (np.complex64, 1)}


def write_capture(path, fmt, n_samples, seed):
    """A random capture of ``n_samples`` complex samples in ``fmt``."""
    rng = np.random.default_rng(seed)
    if fmt == "cf32":
        z = rng.standard_normal(2 * n_samples).astype(np.float32).view(np.complex64)
    else:
        dt = np.int8 if fmt == "int8" else np.int16
        info = np.iinfo(dt)
        z = rng.integers(info.min, info.max + 1, size=2 * n_samples, dtype=dt)
    z.tofile(path)
    return z


class TestRing:
    def test_write_read_roundtrip(self):
        r = tn.NativeRing(1 << 16)
        data = np.arange(1000, dtype=np.uint8)
        assert r.write(data)
        np.testing.assert_array_equal(r.read(1000), data)

    def test_wraparound(self):
        r = tn.NativeRing(1024)
        for i in range(10):
            blk = np.full(600, i, dtype=np.uint8)
            assert r.write(blk)
            np.testing.assert_array_equal(r.read(600), blk)

    def test_drop_on_overrun(self):
        r = tn.NativeRing(1024)
        assert r.write(np.zeros(1000, np.uint8))
        assert not r.write(np.zeros(1000, np.uint8))  # dropped
        assert r.dropped == 1

    def test_read_timeout(self):
        r = tn.NativeRing(1024)
        t0 = time.perf_counter()
        assert r.read(10, timeout_ms=50) is None
        assert 0.04 < time.perf_counter() - t0 < 2.0

    def test_close_unblocks(self):
        r = tn.NativeRing(1024)
        results = []
        t = threading.Thread(target=lambda: results.append(r.read(100, timeout_ms=5000)))
        t.start()
        time.sleep(0.05)
        r.close()
        t.join(timeout=2)
        assert not t.is_alive()
        # the end of the stream, not a timeout: an empty read, not None
        assert len(results) == 1 and results[0] is not None and len(results[0]) == 0

    def test_close_keeps_the_tail(self):
        """After close a read returns what is left, fewer bytes than asked;
        JAX's ring returns nothing (fault 2's cause)."""
        r = tn.NativeRing(1024)
        assert r.write(np.arange(300, dtype=np.uint8))
        r.close()
        np.testing.assert_array_equal(r.read(1000, timeout_ms=100), np.arange(300, dtype=np.uint8))
        assert len(r.read(1000, timeout_ms=100)) == 0
        assert not r.write(np.zeros(10, np.uint8)) and r.dropped == 0  # closed: refused, not dropped
        j = jn.NativeRing(1024)
        assert j.write(np.arange(300, dtype=np.uint8))
        j.close()
        assert j.read(1000, timeout_ms=100) is None

    def test_write_wait_over_capacity_returns_at_once(self):
        r = tn.NativeRing(1024)
        buf = np.zeros(2048, np.uint8)
        t0 = time.perf_counter()
        n = tn.get_lib().tpusdr_host_ring_write_wait(r._h, tn._ptr(buf), buf.nbytes, 5000)
        assert n == 0 and time.perf_counter() - t0 < 1.0

    def test_ping_pong_loses_no_wakeup(self):
        """Thousands of one-block exchanges between two threads through two
        rings: a lost wakeup leaves a read asleep until its 5 s timeout, so
        the whole exchange must end far inside one timeout."""
        n_rounds, nbytes = 3000, 256
        there, back = tn.NativeRing(4 * nbytes), tn.NativeRing(4 * nbytes)
        errors = []

        def echo():
            for _ in range(n_rounds):
                blk = there.read(nbytes, timeout_ms=5000)
                if blk is None or not back.write(blk):
                    errors.append("echo")
                    return

        t = threading.Thread(target=echo)
        t0 = time.perf_counter()
        t.start()
        for i in range(n_rounds):
            assert there.write(np.full(nbytes, i % 256, np.uint8))
            got = back.read(nbytes, timeout_ms=5000)
            assert got is not None and got[0] == i % 256
        t.join(timeout=5)
        assert not t.is_alive() and not errors
        assert time.perf_counter() - t0 < 2.5


class TestFileStream:
    @pytest.mark.parametrize("fmt", ["int8", "int16", "cf32"])
    def test_playback_equals_jax(self, tmp_path, fmt):
        """The port's blocks hold the bytes of JAX's blocks, in the port's
        word dtypes; only the port has the 100-sample tail."""
        path = str(tmp_path / "capture.iq")
        data = write_capture(path, fmt, 4 * 4096 + 100, seed=0)
        with tn.NativeFileStream(path, 4096, fmt) as ours:
            blocks = list(ours)
        theirs = jn.NativeFileStream(path, 4096, fmt)
        jblocks = list(theirs)
        theirs.close()
        assert [len(b) for b in blocks] == [4096] * 4 + [100]
        assert blocks[0].dtype == {"int8": np.int16, "int16": np.int32, "cf32": np.complex64}[fmt]
        jdt, per = JAX_BLOCK[fmt]
        assert len(jblocks) == 4 and all(b.dtype == jdt and len(b) == per * 4096 for b in jblocks)
        for b, jb in zip(blocks, jblocks):
            np.testing.assert_array_equal(np.asarray(b).view(jdt), jb)
        np.testing.assert_array_equal(np.concatenate(blocks).view(data.dtype), data)
        # the same blocks as the port's FileIqSource
        for b, f in zip(blocks, FileIqSource(path, 4096, fmt)):
            np.testing.assert_array_equal(b, f)

    def test_tail_is_kept_fault_2(self, tmp_path):
        path = str(tmp_path / "short.iq")
        write_capture(path, "int8", 1300, seed=1)
        with tn.NativeFileStream(path, 1000, "int8") as ours:
            assert [len(b) for b in ours] == [1000, 300]
        theirs = jn.NativeFileStream(path, 1000, "int8")
        assert [len(b) // 2 for b in theirs] == [1000]  # JAX drops the 300-sample tail
        theirs.close()

    def test_ring_under_64k_works_fault_3(self, tmp_path):
        """A tick of 1,024 int8 samples makes a ring of 16 KiB: the port
        streams all 40 blocks at once; JAX's reader can never place its
        64 KiB piece and its stream yields nothing until the timeout."""
        path = str(tmp_path / "small.iq")
        data = write_capture(path, "int8", 40 * 1024, seed=2)
        t0 = time.perf_counter()
        with tn.NativeFileStream(path, 1024, "int8", timeout_ms=1000) as ours:
            blocks = list(ours)
        assert time.perf_counter() - t0 < 1.0
        assert len(blocks) == 40
        np.testing.assert_array_equal(np.concatenate(blocks).view(np.int8), data)
        theirs = jn.NativeFileStream(path, 1024, "int8", timeout_ms=1000)
        assert list(theirs) == []
        theirs.close()

    def test_loop_wraps_full_blocks_as_file_source_does(self, tmp_path):
        path = str(tmp_path / "loop.iq")
        write_capture(path, "int8", 2500, seed=3)
        with tn.NativeFileStream(path, 1000, "int8", loop=True) as ours:
            it = iter(ours)
            blocks = [next(it) for _ in range(6)]
        ref = FileIqSource(path, 1000, "int8", loop=True)
        for b, f in zip(blocks, ref):
            np.testing.assert_array_equal(b, f)

    def test_close_stops_the_reader_mid_stream(self, tmp_path):
        """Closing with most of the file unread returns at once (the reader
        is joined, not left writing into a freed ring); the iterator then
        drains what the ring held and ends."""
        path = str(tmp_path / "long.iq")
        write_capture(path, "int8", 200 * 1024, seed=4)
        stream = tn.NativeFileStream(path, 1024, "int8", ring_blocks=4)
        it = iter(stream)
        first = next(it)
        t0 = time.perf_counter()
        stream.close()
        assert time.perf_counter() - t0 < 1.0
        rest = list(it)
        assert len(first) == 1024 and len(rest) <= 4

    def test_missing_file_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            tn.NativeFileStream(str(tmp_path / "nope.iq"), 1024, "int8")


def exact_ties():
    """float32 x whose x * 32767 is exactly k + 1/2 in float32."""
    out = []
    for k in range(-40, 40):
        x = np.float32((k + 0.5) / 32767)
        for c in (np.nextafter(x, np.float32(-1)), x, np.nextafter(x, np.float32(1))):
            if np.float32(c) * np.float32(32767) == np.float32(k + 0.5):
                out.append(c)
                break
    return np.array(out, np.float32)


class TestConvert:
    def test_f32_to_i16(self):
        x = np.array([-1.5, -1.0, 0.0, 0.5, 1.0, 1.5], np.float32)
        np.testing.assert_array_equal(tn.f32_to_i16(x), [-32768, -32767, 0, 16384, 32767, 32767])

    def test_f32_to_i16_equals_jax_c_form_fault_13(self, monkeypatch):
        rng = np.random.default_rng(5)
        ties = exact_ties()
        assert len(ties) >= 60
        for x in (rng.uniform(-1.2, 1.2, 200_000).astype(np.float32), ties):
            ours = tn.f32_to_i16(x)
            np.testing.assert_array_equal(ours, jn.f32_to_i16(x))  # JAX's C form
            np.testing.assert_array_equal(ours, tn.f32_to_i16_plain(x))
        # JAX's NumPy fallback, what its f32_to_i16 gives without its
        # library, rounds the ties to even
        monkeypatch.setattr(jn, "get_lib", lambda: None)
        fallback = jn.f32_to_i16(ties)
        assert not np.array_equal(fallback, tn.f32_to_i16(ties))
        np.testing.assert_array_equal(fallback, np.round(ties * np.float32(32767)).astype(np.int16))


class TestBuild:
    def test_library_is_built_into_build_dir(self):
        path = tn.build()
        assert path.parent == tn.BUILD_DIR and path.name.startswith("libtpusdr_host_") and path.exists()
        assert tn.native_available()

    @pytest.mark.parametrize("cxx", ["false", "/nonexistent/c++"])
    def test_failed_build_raises(self, monkeypatch, cxx):
        monkeypatch.setenv("CXX", cxx)
        with pytest.raises(RuntimeError, match="host build failed"):
            tn.build()

    def test_cli_native_without_the_library_exits(self, monkeypatch, tmp_path, capsys):
        """--native never falls back to another reader."""
        path = str(tmp_path / "c.iq")
        write_capture(path, "int8", 4096, seed=6)

        def broken():
            raise RuntimeError("host build failed (1): c++")

        monkeypatch.setattr(tn, "get_lib", broken)
        with pytest.raises(SystemExit) as e:
            treceive.main(["--device", "cpu", "--mod", "am", "--format", "int8", "--input", path, "--native"])
        assert e.value.code == 2 and "--native: host build failed" in capsys.readouterr().err


class TestIngestThroughput:
    """The ingest bar of tests/test_native.py: a 40 MB int8 capture read
    ahead at 20 Msps or more (the reference's real-time design point,
    nbfm_test.cpp:415), its tail counted.  A wiring check, not a bench: the
    words are not converted on the host (they convert on the card)."""

    def test_native_file_ingest_over_20msps(self, tmp_path):
        path = str(tmp_path / "cap.iq")
        total = 40_000_000  # 20M complex samples of int8 IQ
        np.random.default_rng(3).integers(-128, 128, size=total, dtype=np.int8).tofile(path)
        tick = 1 << 20
        with tn.NativeFileStream(path, tick, "int8") as stream:
            t0 = time.perf_counter()
            samples = 0
            for words in stream:
                samples += len(words)
            dt = time.perf_counter() - t0
        msps = samples / dt / 1e6
        assert samples == total // 2
        assert msps >= 20.0, f"native ingest {msps:.1f} Msps < 20 Msps"
