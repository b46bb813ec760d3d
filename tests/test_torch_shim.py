"""The port's RF-host shim (tpusdr_torch/io/shim.py, apps/rf_shim.py) and
its retune-flush protocol, case for case with tests/test_shim.py, and
against the JAX package's.

The loop under test is the reference's HackrfSource deployment split
across hosts: fake radio -> RfShim (control + data sockets) ->
SocketIqSource -> the port's receiver chain -> SdrReceiverControl retune.
IQ captured at the OLD centre must never be demodulated with the NEW NCO:
the shim reports ``stream_pos`` (bytes sent before the retune applied)
and the source drops every block holding earlier bytes.

Tolerances: FakeSdrDriver's bytes equal JAX's bit for bit (the same numpy
arithmetic); the WBFM loop's 1 kHz tone at amplitude 0.34 +- 0.03 on both
sides of the retune.  Every socket read has its own timeout.
"""

import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tpusdr.io import shim as jshim
from tpusdr_torch.graph import blocks as B
from tpusdr_torch.graph.chain import Chain
from tpusdr_torch.graph.runner import StreamRunner
from tpusdr_torch.io import FakeSdrDriver, RfShim, Station
from tpusdr_torch.io.control import SdrControlClient, SdrControlError, SdrReceiverControl
from tpusdr_torch.io.sinks import CollectSink
from tpusdr_torch.io.sources import SocketIqSource
from tpusdr_torch.models import receiver

torch.set_num_threads(1)


def _shim(stations=(), **kw):
    driver = FakeSdrDriver(stations=list(stations), **kw)
    return RfShim(driver)


class TestControlSurface:
    def test_enumerate_select_by_index_and_serial(self):
        with _shim(serials=("fake-a", "fake-b")) as shim:
            with SdrControlClient("127.0.0.1", shim.control_port) as c:
                devices = c.ping()["devices"]
                assert [d["serial"] for d in devices] == ["fake-a", "fake-b"]
                c.select_device(index=1)
                assert shim.driver._opened == "fake-b"
                c.select_device(serial="fake-a")
                assert shim.driver._opened == "fake-a"
                with pytest.raises(SdrControlError, match="serial"):
                    c.select_device(serial="nope")

    def test_full_command_set(self):
        with _shim() as shim:
            with SdrControlClient("127.0.0.1", shim.control_port) as c:
                c.select_device(index=0)
                c.set_sample_rate(2e6)
                c.set_frequency(100e6)
                c.set_gain(lna_db=16, vga_db=20, amp=True)
                c.start()
                c.stop()
                d = shim.driver
                assert (d.fs, d.center_hz, d.lna_db, d.vga_db, d.amp) == (2e6, 100e6, 16, 20, True)

    def test_set_frequency_reports_stream_pos(self):
        with _shim() as shim:
            with SdrControlClient("127.0.0.1", shim.control_port) as c:
                c.select_device(index=0)
                reply = c.set_frequency(99e6)
                assert reply["stream_pos"] == 0  # nothing sent yet

    def test_start_requires_open_device(self):
        with _shim() as shim:
            with SdrControlClient("127.0.0.1", shim.control_port) as c:
                c.start()  # pump starts; read_block fails and the pump exits
                deadline = time.time() + 5.0
                while shim.started and time.time() < deadline:
                    time.sleep(0.01)
                assert not shim.started
                c.stop()


class TestFakeRadioAgainstJax:
    def test_bytes_equal_jax_bit_for_bit(self):
        """The same stations, noise, seed and sequence of retunes and gain
        changes give the JAX driver's bytes."""
        stations = [("cw", 100.1e6, 0.4, 1000.0), ("fm", 99.7e6, 0.3, 700.0), ("fm", 103e6, 0.5, 1200.0)]
        drivers = []
        for mod in (sys.modules[FakeSdrDriver.__module__], jshim):
            sts = [mod.Station(f, kind, amplitude=a, audio_hz=ah) for kind, f, a, ah in stations]
            drv = mod.FakeSdrDriver(sts, block_samples=3000, noise=0.02, seed=11)
            drv.open(index=0)
            drv.set_sample_rate(4e6)
            drv.set_frequency(100e6)
            drivers.append(drv)
        ours, theirs = [], []
        for step in range(8):
            for drv, out in zip(drivers, (ours, theirs)):
                if step == 3:
                    drv.set_frequency(101.5e6)  # 103 MHz comes into the band, 99.7 leaves
                if step == 5:
                    drv.set_gain(lna_db=24, vga_db=20, amp=True)
                out.append(drv.read_block())
        assert ours == theirs
        assert len(set(ours)) == len(ours) and all(len(b) == 2 * 3000 for b in ours)

    def test_station_parse(self):
        st = Station.parse("100.1e6:fm:1000")
        assert (st.freq_hz, st.kind, st.audio_hz) == (100.1e6, "fm", 1000.0)
        with pytest.raises(ValueError, match="station kind"):
            Station.parse("100e6:am")


def _dominant_freq(blocks_iq_words, fs):
    """Dominant baseband frequency of packed-int16-word int8 IQ blocks."""
    w = np.concatenate(blocks_iq_words)
    i = (np.left_shift(w.astype(np.int32), 24) >> 24).astype(np.float32)
    q = (w.astype(np.int32) >> 8).astype(np.float32)
    z = (i + 1j * q) / 128.0
    spec = np.abs(np.fft.fft(z))
    k = int(np.argmax(spec))
    return np.fft.fftfreq(len(z), d=1.0 / fs)[k]


def wait_sent(shim, nbytes):
    """Until the shim has sent ``nbytes`` (5 s at most): the flush tests
    need blocks captured at the old centre in flight at the retune."""
    deadline = time.time() + 5.0
    while shim.bytes_sent < nbytes and time.time() < deadline:
        time.sleep(0.001)


class TestRetuneFlush:
    def test_flush_drops_old_center_iq(self):
        """Step the radio center mid-stream: after skip_until_byte, the
        first surviving block must already be at the new offset — no block
        of old-center samples (or a straddling block) leaks through."""
        fs = 1e6
        station = Station(100.1e6, "cw", amplitude=0.8)
        with _shim([station], block_samples=4096) as shim:
            with SdrControlClient("127.0.0.1", shim.control_port) as c:
                c.select_device(index=0)
                c.set_sample_rate(fs)
                c.set_frequency(100.0e6)  # station appears at +100 kHz
                c.start()
                src = SocketIqSource("127.0.0.1", shim.data_port, 4096, "int8", pool_blocks=64)
                it = iter(src)
                pre = [next(it) for _ in range(6)]
                assert abs(_dominant_freq(pre, fs) - 100e3) < 2e3

                # retune: station should appear at +50 kHz — flush first
                reply = c.set_frequency(100.05e6)
                src.skip_until_byte(int(reply["stream_pos"]))
                post = [next(it) for _ in range(6)]
                src.close()
                c.stop()
        # EVERY post-flush block individually sits at the new offset
        for blk in post:
            f = _dominant_freq([blk], fs)
            assert abs(f - 50e3) < 2e3, f"stale-center block leaked: {f}"

    def test_without_flush_stale_blocks_leak(self):
        """Control experiment: skipping the flush DOES leak old-center
        blocks (proves the test above tests something real)."""
        fs = 1e6
        station = Station(100.1e6, "cw", amplitude=0.8)
        with _shim([station], block_samples=4096) as shim:
            with SdrControlClient("127.0.0.1", shim.control_port) as c:
                c.select_device(index=0)
                c.set_sample_rate(fs)
                c.set_frequency(100.0e6)
                c.start()
                src = SocketIqSource("127.0.0.1", shim.data_port, 4096, "int8", pool_blocks=64)
                it = iter(src)
                for _ in range(6):
                    next(it)
                # old-centre blocks in flight: the pump ten blocks ahead of
                # the reader (a slow pump start made this race under load)
                wait_sent(shim, 16 * 2 * 4096)
                c.set_frequency(100.05e6)  # NO flush
                post = [next(it) for _ in range(4)]
                src.close()
                c.stop()
        f_first = _dominant_freq([post[0]], fs)
        assert abs(f_first - 100e3) < 2e3, (
            f"expected the first unflushed post-retune block to still be at the old offset, got {f_first}"
        )


class Collect:
    def __init__(self):
        self.blocks = []

    def write(self, x):
        self.blocks.append(np.asarray(x))


def tone_fit(x, fs, f=1000.0):
    x = x.astype(np.float64)
    t = np.arange(len(x)) / fs
    b = np.stack([np.sin(2 * np.pi * f * t), np.cos(2 * np.pi * f * t)], 1)
    c, *_ = np.linalg.lstsq(b, x, rcond=None)
    fit = b @ c
    r = x - fit - (x - fit).mean()
    return float(np.hypot(*c)), float(10 * np.log10((fit**2).mean() / (r**2).mean()))


class TestEndToEnd:
    def test_fake_radio_to_audio_with_retune(self):
        """The full loop: fake radio -> shim -> SocketIqSource -> the port's
        chain -> SdrReceiverControl.tune_radio, with a frequency-stepped
        radio and assertions on the transition."""
        fs = 1e6
        tick = 65536
        station = Station(100.1e6, "cw", amplitude=0.7)
        chain = Chain([("conv", B.IqToComplex("int8")), ("shift", B.FreqShift(fs, -100e3))])
        runner = StreamRunner(chain, pipeline_depth=0)

        with _shim([station], block_samples=tick) as shim:
            with SdrControlClient("127.0.0.1", shim.control_port) as c:
                c.select_device(index=0)
                c.set_sample_rate(fs)
                c.set_frequency(100.0e6)  # station offset +100 kHz
                src = SocketIqSource("127.0.0.1", shim.data_port, tick, "int8", pool_blocks=64)
                ctrl = SdrReceiverControl(c, runner, center_hz=100.0e6, channel_hz=100.1e6, source=src)
                c.start()

                it = iter(src)
                sink1, sink2 = Collect(), Collect()
                state, _ = runner.run(it, sink1, max_blocks=3)
                # phase 1: shifted station sits at DC (constant phasor)
                z1 = np.concatenate(sink1.blocks, axis=-1)
                assert np.std(np.angle(z1[1:] * np.conj(z1[:-1]))) < 0.02

                # retune radio to 100.05 MHz, keep listening to the station:
                # NCO re-aims at -(100.1e6 - 100.05e6) = -50 kHz
                wait_sent(shim, 5 * 2 * tick)
                ctrl.tune_radio(100.05e6)
                assert src.flushed_blocks == 0  # lazily flushed on next read
                state, _ = runner.run(it, sink2, state=state, max_blocks=3)
                assert src.flushed_blocks > 0  # in-flight old IQ was cut
                z2 = np.concatenate(sink2.blocks, axis=-1)
                # EVERY post-retune tick is already coherent at the new center
                dphi = np.angle(z2[1:] * np.conj(z2[:-1]))
                assert np.std(dphi) < 0.02, "stale IQ reached the demodulator"
                assert src.dropped_blocks == 0
                src.close()
                c.stop()

    def test_fm_receiver_loop_decodes_across_a_retune(self):
        """The slice's path at a CPU size: an FM station through the shim
        into fm_receiver(int8) with its folded front end (``shiftfir``),
        retuned by tune_radio; the 1 kHz tone decodes on both sides (the
        first tick after the retune skipped: the filters settle)."""
        fs, centre, tick = 2e6, 97.6e6, 80_000
        chain, spec = receiver.fm_receiver(fs, 500e3, receiver.WBFM, input_format="int8")
        runner = StreamRunner(chain)
        station = Station(centre + 500e3, "fm", amplitude=0.9)
        with _shim([station], block_samples=tick) as shim:
            with SdrControlClient("127.0.0.1", shim.control_port) as c:
                c.select_device(index=0)
                c.set_sample_rate(fs)
                c.set_frequency(centre)
                src = SocketIqSource("127.0.0.1", shim.data_port, tick, "int8", pool_blocks=64)
                ctrl = SdrReceiverControl(c, runner, centre, centre + 500e3, source=src)
                assert ctrl.shift_block == "shiftfir"
                c.start()
                it = iter(src)
                before, after = CollectSink(), CollectSink()
                state, _ = runner.run(it, before, max_blocks=6)
                wait_sent(shim, 8 * 2 * tick)
                ctrl.tune_radio(centre + 800e3)  # the station now at -300 kHz
                assert chain.get_block("shiftfir").frequency == pytest.approx(300e3)
                runner.run(it, after, state=state, max_blocks=6)
                src.close()
                c.stop()
        assert src.flushed_blocks > 0 and src.dropped_blocks == 0
        per_tick = tick * chain.up // chain.down
        for audio in (before.result()[per_tick:], after.result()[per_tick:]):
            amp, snr = tone_fit(audio, spec.audio_rate)
            assert abs(amp - 0.375 * 0.905) < 0.03 and snr > 30.0, (amp, snr)

    def test_cli_smoke(self):
        """The shim is runnable as a program and prints its banner."""
        proc = subprocess.Popen(
            [sys.executable, "-m", "tpusdr_torch.apps.rf_shim", "--driver", "fake",
             "--stations", "100.1e6:fm:1000", "--control-port", "0", "--data-port", "0"],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        try:
            for _ in range(10):  # skip any log lines interleaved on stdout
                line = proc.stdout.readline()
                if "rf shim: control" in line:
                    break
            else:
                raise AssertionError("shim banner not printed")
            assert line.startswith("rf shim: control 127.0.0.1:") and ", data 127.0.0.1:" in line
        finally:
            proc.terminate()
            proc.wait(timeout=5)
