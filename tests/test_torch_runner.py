"""The port's StreamRunner, run_offline, sources, sinks and receive CLI on
the CPU, against the port's own Chain.apply and against the JAX package.

Tolerances: runner output equal to Chain.apply bit for bit (the same ops
on the same tensors); sources and sinks byte for byte against JAX; the
CLI's 700 Hz tone at amplitude 0.25 +- 0.02 and SNR > 60 dB (the verify
skill's fit), and its audio within -80 dB error energy of the JAX CLI's
(both WAV files are 16-bit, so this also bounds the quantisation).
"""

import socket
import threading
import time
import wave

import numpy as np
import pytest
import torch

from tpusdr.apps import receive as jreceive
from tpusdr.io import sinks as jsinks
from tpusdr.io import sources as jsources
from tpusdr_torch.apps import receive as treceive
from tpusdr_torch.graph import blocks as TB
from tpusdr_torch.graph.chain import Chain
from tpusdr_torch.graph.runner import StreamRunner, run_offline
from tpusdr_torch.io import sinks as tsinks
from tpusdr_torch.io.sources import CallbackSource, FileIqSource, SocketIqSource, SyntheticIqSource
from tpusdr_torch.models import receiver as TR

torch.set_num_threads(1)


@pytest.fixture
def rng():
    return np.random.default_rng(51)


def read_wav(path):
    with wave.open(str(path)) as w:
        fs = w.getframerate()
        x = np.frombuffer(w.readframes(w.getnframes()), dtype="<i2").astype(np.float32) / 32767
    return x, fs


def tone_fit(x, fs, f=700.0):
    x = x[len(x) // 3 :].astype(np.float64)
    t = np.arange(len(x)) / fs
    b = np.stack([np.sin(2 * np.pi * f * t), np.cos(2 * np.pi * f * t)], 1)
    c, *_ = np.linalg.lstsq(b, x, rcond=None)
    fit = b @ c
    r = x - fit - (x - fit).mean()
    return float(np.hypot(*c)), float(10 * np.log10((fit**2).mean() / (r**2).mean()))


def chain_apply(chain, ticks):
    state = chain.init_state()
    outs = []
    for x in ticks:
        state, y = chain.apply(state, torch.from_numpy(np.array(x)))
        outs.append(y.numpy())
    return outs


# -- StreamRunner ---------------------------------------------------------------------


@pytest.mark.parametrize("upload_depth,pipeline_depth", [(0, 0), (2, 2), (1, 3)])
def test_runner_equals_chain_apply(upload_depth, pipeline_depth):
    chain, _ = TR.am_receiver(2e6, 100e3, input_format="int8")
    ticks = list(SyntheticIqSource.am(50000, 2e6, 100e3, "int8", num_blocks=4))
    sink = tsinks.CollectSink()
    _, stats = StreamRunner(chain, pipeline_depth, upload_depth=upload_depth).run(iter(ticks), sink)
    ref = chain_apply(chain, ticks)
    assert len(sink.blocks) == 4 and stats.blocks == 4 and stats.samples_in == 200000
    for got, want in zip(sink.blocks, ref):
        np.testing.assert_array_equal(got, want)
    assert stats.samples_out == sum(len(r) for r in ref) == 4 * 50000 * 6 // 250


def test_runner_reads_a_file_to_its_end(tmp_path):
    """A capture of 3.4 ticks: every owed sample comes out (the JAX
    package's FileIqSource drops the last 0.4 tick, reference fault 3.4)."""
    chain, spec = TR.am_receiver(2e6, 100e3, input_format="int8")
    tick = 50000
    n = 3 * tick + 20250  # not a multiple of the granule (250) either
    words = next(iter(SyntheticIqSource.am(n, 2e6, 100e3, "int8", num_blocks=1)))
    path = tmp_path / "cap.iq"
    words.tofile(path)
    assert len(list(jsources.FileIqSource(str(path), tick, "int8"))) == 3  # the fault
    src = FileIqSource(str(path), tick, "int8")
    assert src.num_blocks == 4
    sink = tsinks.CollectSink()
    _, stats = StreamRunner(chain).run(iter(src), sink)
    owed = n * chain.up // chain.down
    assert stats.samples_in == n and stats.samples_out == owed
    padded = np.zeros(4 * tick, np.int16)
    padded[:n] = words
    ref = np.concatenate(chain_apply(chain, np.split(padded, 4)))
    np.testing.assert_array_equal(sink.result(), ref[:owed])


def test_runner_refuses_a_short_block_mid_stream():
    chain = Chain([("c", TB.AddConst(0.5))])
    chain.stages["d"] = TB.Fir(np.ones(3, np.float32), 4, "Float")
    chain._recompute_plan()
    blocks = [np.zeros(8, np.float32), np.zeros(6, np.float32), np.zeros(8, np.float32)]
    with pytest.raises(ValueError, match="only the last"):
        StreamRunner(chain).run(iter(blocks), tsinks.NullSink())


class _TwoPorts(TB.Block):
    """A block with two outputs, as a tapped graph has."""

    def apply(self, state, x):
        return state, (x + 1.0, x * 2.0)


def test_runner_feeds_one_sink_per_port():
    blocks = [np.arange(8, dtype=np.float32) + 8 * i for i in range(3)]
    a, b = tsinks.CollectSink(), tsinks.CollectSink()
    _, stats = StreamRunner(_TwoPorts(), device="cpu").run(iter(blocks), [a, b], postprocess=[None, np.negative])
    x = np.concatenate(blocks)
    np.testing.assert_array_equal(a.result(), x + 1.0)
    np.testing.assert_array_equal(b.result(), -2.0 * x)
    assert stats.samples_out_ports == [24, 24] and stats.samples_out == 24
    with pytest.raises(ValueError, match="2 outputs but 1 sinks"):
        StreamRunner(_TwoPorts(), device="cpu").run(iter(blocks), tsinks.NullSink())


def test_runner_source_error_and_max_blocks():
    chain = Chain([("c", TB.AddConst(0.5))])

    def bad_source():
        yield np.zeros(256, np.float32)
        raise OSError("wire fell out")

    with pytest.raises(OSError, match="wire fell out"):
        StreamRunner(chain, device="cpu", upload_depth=2).run(bad_source(), tsinks.NullSink())
    sink = tsinks.CollectSink()
    _, stats = StreamRunner(chain, device="cpu").run((np.zeros(256, np.float32) for _ in range(100)), sink, max_blocks=3)
    assert stats.blocks == 3 and sink.samples_written == 768


def test_runner_raw_int8_raises():
    chain, _ = TR.am_receiver(2e6, 100e3, input_format="int8")
    with pytest.raises(TypeError, match="packed"):
        StreamRunner(chain, upload_depth=0).run(iter([np.zeros(500, np.int8)]), tsinks.NullSink())


PACE_S = 0.025  # a radio's block period here, far longer than a tick of ``quick_chain``


def quick_chain():
    """A chain whose CPU tick takes well under a millisecond, with a
    granule (4) and a rate change: AddConst, then a 3-tap FIR by 4."""
    chain = Chain([("c", TB.AddConst(0.5))])
    chain.stages["d"] = TB.Fir(np.ones(3, np.float32), 4, "Float")
    chain._recompute_plan()
    return chain


def paced(blocks, log, period=PACE_S):
    """``blocks`` one ``period`` apart, as a radio hands them over, each
    logged as it is handed over.  The stream ends one period after its last
    block, as a radio that is closed does (a file ends at once)."""
    for k, b in enumerate(blocks):
        time.sleep(period)
        log.append(("yield", k))
        yield b
    time.sleep(period)


class LogSink(tsinks.CollectSink):
    """A CollectSink that logs each write."""

    def __init__(self, log, tag="write"):
        super().__init__()
        self.log, self.tag = log, tag

    def write(self, x):
        self.log.append((self.tag, len(self.blocks)))
        super().write(x)


@pytest.mark.parametrize("upload_depth", [2, 0])
def test_runner_drains_a_paced_block_before_the_next_arrives(upload_depth):
    """Blocks 25 ms apart: each block's output reaches the sink before the
    source hands over the next one (the depth alone would hold it until
    block k+2 was stepped), and every tick is drained early."""
    chain = quick_chain()
    blocks = [np.arange(64, dtype=np.float32) + 64 * k for k in range(5)]
    ref = chain_apply(chain, blocks)  # also fills the chain's caches
    log = []
    sink = LogSink(log)
    runner = StreamRunner(chain, pipeline_depth=2, device="cpu", upload_depth=upload_depth)
    _, stats = runner.run(paced(blocks, log), sink)
    assert stats.blocks == 5 and stats.early_drains == 5
    for k in range(4):
        assert log.index(("write", k)) < log.index(("yield", k + 1)), log
    for got, want in zip(sink.blocks, ref):
        np.testing.assert_array_equal(got, want)


class _Unfinished:
    """A copy-out event that reports unfinished until it is waited on."""

    def __init__(self):
        self.done = False

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True


@pytest.mark.parametrize("upload_depth,pipeline_depth", [(2, 2), (0, 2), (1, 3)])
def test_runner_drains_only_at_the_depth_while_ticks_run(monkeypatch, upload_depth, pipeline_depth):
    """A source that is always ready and copies that never finish on their
    own: tick k is drained right after tick k + depth is stepped, the last
    ``depth`` at the stream's end, none early, and the audio is
    ``Chain.apply``'s."""
    chain, _ = TR.am_receiver(2e6, 100e3, input_format="int8")
    ticks = list(SyntheticIqSource.am(50000, 2e6, 100e3, "int8", num_blocks=6))
    runner = StreamRunner(chain, pipeline_depth, upload_depth=upload_depth)
    log = []

    def fetch(y):
        log.append(("step", sum(e[0] == "step" for e in log)))
        return y, _Unfinished()

    monkeypatch.setattr(runner, "_fetch", fetch)
    sink = LogSink(log)
    _, stats = runner.run(iter(ticks), sink)
    assert stats.blocks == 6 and stats.early_drains == 0
    want = []
    for k in range(6):
        want.append(("step", k))
        if k >= pipeline_depth:
            want.append(("write", k - pipeline_depth))
    want += [("write", k) for k in range(max(0, 6 - pipeline_depth), 6)]
    assert log == want
    for got, ref in zip(sink.blocks, chain_apply(chain, ticks)):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("upload_depth", [2, 0])
def test_runner_drained_early_keeps_the_padded_tail(upload_depth):
    """A paced stream whose last block is short: the tail is padded to the
    granule and its output trimmed to what its real input owes, as in a
    backlogged run."""
    chain = quick_chain()
    n = 3 * 64 + 30  # not a multiple of the granule (4)
    words = np.arange(n, dtype=np.float32)
    blocks = [words[k * 64 : (k + 1) * 64] for k in range(4)]
    padded = np.zeros(4 * 64, np.float32)
    padded[:n] = words
    owed = n * chain.up // chain.down
    ref = np.concatenate(chain_apply(chain, np.split(padded, 4)))[:owed]
    sink = tsinks.CollectSink()
    runner = StreamRunner(chain, device="cpu", upload_depth=upload_depth)
    _, stats = runner.run(paced(blocks, [], 0.01), sink)
    assert stats.early_drains == 4 and stats.samples_in == n and stats.samples_out == owed
    np.testing.assert_array_equal(sink.result(), ref)


class _Finished:
    """A copy-out event that is already done, as a card's is soon after its tick."""

    def query(self):
        return True

    def synchronize(self):
        pass


def test_runner_queue_span_holds_no_drain():
    """Traced, a paced stream's ``queue`` spans (the wait for the upload
    thread) begin again after each tick drained while waiting: none covers
    a ``drain_wait`` or ``sink`` span, and there is one a block and one for
    the stream's end."""
    from tpusdr_torch.utils.tracing import Tracer

    chain = quick_chain()
    blocks = [np.arange(64, dtype=np.float32) + 64 * k for k in range(4)]
    chain_apply(chain, blocks)
    with Tracer() as tr:
        runner = StreamRunner(chain, device="cpu")
    runner._fetch = lambda y: (y, _Finished())
    _, stats = runner.run(paced(blocks, [], 0.01), tsinks.CollectSink())
    assert stats.early_drains == 4
    sp = tr.spans()

    def spans(name):
        m = sp["name"] == sp["names"].index(name)
        return list(zip(sp["t0"][m].tolist(), sp["t1"][m].tolist()))

    queue, drains = spans("queue"), spans("drain_wait") + spans("sink")
    assert len(queue) == 5 and len(drains) == 8
    for a, b in queue:
        for c, d in drains:
            assert d <= a or c >= b, (a, b, c, d)


@pytest.mark.parametrize("upload_depth", [2, 0])
def test_runner_drained_early_feeds_each_port(upload_depth):
    """A paced two-port block: each port's sink gets its own samples, in
    order, each block drained before the next arrives."""
    blocks = [np.arange(8, dtype=np.float32) + 8 * i for i in range(4)]
    log = []
    a, b = LogSink(log, "a"), LogSink(log, "b")
    runner = StreamRunner(_TwoPorts(), device="cpu", upload_depth=upload_depth)
    _, stats = runner.run(paced(blocks, log, 0.01), [a, b], postprocess=[None, np.negative])
    assert stats.early_drains == 4 and stats.samples_out_ports == [32, 32]
    for k in range(3):
        assert log.index(("b", k)) < log.index(("yield", k + 1)), log
    x = np.concatenate(blocks)
    np.testing.assert_array_equal(a.result(), x + 1.0)
    np.testing.assert_array_equal(b.result(), -2.0 * x)


def test_run_offline_flat_equals_scan_with_a_channel_axis(rng):
    """'flat' joins only the tick axis to the time axis, so a leading
    channel axis survives (the JAX package's 'flat' merges ticks into
    channels, reference fault 3.1)."""
    chain, _ = TR.fm_receiver(2e6, 300e3, TR.WBFM)
    K, C, n = 3, 2, 40000
    z = (rng.standard_normal((K, C, n)) + 1j * rng.standard_normal((K, C, n))).astype(np.complex64)
    x = torch.from_numpy(z)
    _, flat = run_offline(chain, x, mode="flat")
    _, scan = run_offline(chain, x, mode="scan")
    _, auto = run_offline(chain, x)
    out = chain.out_len(n)
    assert flat.shape == (C, K * out) and scan.shape == (K, C, out)
    np.testing.assert_allclose(flat.numpy(), scan.movedim(0, -2).reshape(C, K * out).numpy(), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(auto.numpy(), flat.numpy())
    per_channel = chain_apply(chain, [z[k, 1] for k in range(K)])
    np.testing.assert_allclose(flat[1].numpy(), np.concatenate(per_channel), rtol=0, atol=1e-5)


# -- sources ----------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["int8", "int16", "float32", "cf32"])
def test_file_and_synthetic_sources_match_jax(tmp_path, fmt):
    """Whole blocks equal JAX's block for block; the port also yields the
    short last block."""
    got = list(SyntheticIqSource.fm(3000, 2e6, carrier_offset=300e3, output_format=fmt, num_blocks=3))
    ref = list(jsources.SyntheticIqSource.fm(3000, 2e6, carrier_offset=300e3, output_format=fmt, num_blocks=3))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    path = tmp_path / "cap.bin"
    data = np.concatenate(got)
    data[: len(data) - 333].tofile(path)  # not a whole number of blocks
    tb = list(FileIqSource(str(path), 1000, fmt))
    jb = list(jsources.FileIqSource(str(path), 1000, fmt))
    assert len(tb) == len(jb) + 1
    for g, r in zip(tb, jb):
        np.testing.assert_array_equal(g, r)
    assert len(tb[-1]) < len(tb[0]) and np.array_equal(np.concatenate(tb), np.fromfile(path, data.dtype))


def test_file_source_loop_wraps_full_blocks(tmp_path):
    w = np.arange(250, dtype=np.int16)
    path = tmp_path / "loop.iq"
    w.tofile(path)
    blocks = list(FileIqSource(str(path), 100, "int8", loop=True, max_blocks=5))
    assert [len(b) for b in blocks] == [100] * 5
    np.testing.assert_array_equal(np.concatenate(blocks), np.resize(w, 500))


def test_socket_and_callback_sources():
    srv = socket.socket()
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("localhost", 0))
    srv.listen(1)
    port = srv.getsockname()[1]
    words = np.arange(4 * 512, dtype=np.int16)

    def serve():
        conn, _ = srv.accept()
        conn.sendall(words.tobytes())
        conn.close()
        srv.close()

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    got = list(SocketIqSource("localhost", port, 512, "int8", pool_blocks=8))
    th.join(timeout=10)
    assert not th.is_alive()
    np.testing.assert_array_equal(np.concatenate(got), words)
    cb = list(CallbackSource(lambda i: np.full(4, i, np.float32) if i < 3 else None))
    assert [b[0] for b in cb] == [0, 1, 2]


# -- sinks ------------------------------------------------------------------------------


def test_sinks_write_what_jax_writes(tmp_path, rng):
    pcm = [np.clip(rng.standard_normal(480) * 0.3, -1.2, 1.2).astype(np.float32) for _ in range(3)]
    for name, tsink, jsink in (
        ("a.wav", tsinks.WavSink, jsinks.WavSink),
        ("a.raw", tsinks.RawFileSink, jsinks.RawFileSink),
    ):
        args = (48000.0,) if name.endswith("wav") else (np.float32,)
        with tsink(str(tmp_path / ("t" + name)), *args) as t, jsink(str(tmp_path / ("j" + name)), *args) as j:
            for b in pcm:
                t.write(b)
                j.write(b)
        assert (tmp_path / ("t" + name)).read_bytes() == (tmp_path / ("j" + name)).read_bytes()
    c, n = tsinks.CollectSink(), tsinks.NullSink()
    for b in pcm:
        c.write(b)
        n.write(b)
    assert c.result().shape == (1440,) and n.samples_written == 1440


def test_aac_sink_frames_and_missing_ffmpeg(tmp_path):
    written = bytearray()

    class Proc:
        def __init__(self, args, **kw):
            self.args = args
            self.stdin = type("In", (), {"write": lambda s, b: written.extend(b), "close": lambda s: None})()
            self.stderr = None

        def wait(self):
            return 0

    sink = tsinks.AacFileSink(str(tmp_path / "o.aac"), 48000.0, _popen=Proc)
    sink.write(np.ones(600, np.float32))
    assert len(written) == 0
    sink.write(np.ones(600, np.float32))
    assert len(written) == 1024 * 4
    sink.close()
    assert len(written) == 1200 * 4
    with pytest.raises(FileNotFoundError):
        tsinks.AacFileSink(str(tmp_path / "x.aac"), 48000.0, ffmpeg="/nonexistent/ffmpeg")


# -- the receive CLI --------------------------------------------------------------------


CLI_ARGS = ["--mod", "am", "--format", "int8", "--input", "synth", "--rf-rate", "2e6",
            "--offset", "100e3", "--duration", "1", "--tick", "200000"]


def test_cli_am_int8_decodes_and_matches_jax_cli(tmp_path, capsys):
    ours, theirs = tmp_path / "t.wav", tmp_path / "j.wav"
    assert treceive.main(CLI_ARGS + ["--device", "cpu", "--audio", str(ours)]) == 0
    assert "on cpu" in capsys.readouterr().out
    assert jreceive.main(CLI_ARGS + ["--platform", "cpu", "--audio", str(theirs)]) == 0
    x, fs = read_wav(ours)
    amp, snr = tone_fit(x, fs)
    assert abs(amp - 0.25) < 0.02 and snr > 60.0, (amp, snr)
    ref, jfs = read_wav(theirs)
    assert fs == jfs == 48000 and x.shape == ref.shape == (48000,)
    assert 10 * np.log10(np.sum((x - ref) ** 2) / np.sum(ref**2)) <= -80.0


def test_cli_refuses_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        treceive.main(["--mod", "am"])
    assert e.value.code == 2


@pytest.mark.parametrize("opt", [["--dot", "g.dot"], ["--dump-if", "if.raw"], ["--checkpoint", "c"],
                                 ["--resume", "c"], ["--native"]])
def test_cli_unported_options_raise(opt, capsys, tmp_path, monkeypatch):
    """Every option of the JAX CLI now runs; this test once saw them
    refused.  The graph-layer options write their files (their outputs are
    held to the JAX CLI's in tests/test_torch_digital.py); ``--native`` is
    checked in ``check_native``."""
    monkeypatch.chdir(tmp_path)
    if opt == ["--native"]:
        check_native(tmp_path, capsys)
        return
    short = ["--device", "cpu", "--rf-rate", "2e6", "--offset", "3e5", "--duration", "0.05", "--tick", "50000"]
    if opt[0] == "--resume":
        assert treceive.main(short + ["--checkpoint", "c.npz"]) == 0
        opt = ["--resume", "c.npz"]
    assert treceive.main(short + opt) == 0
    assert "not ported" not in capsys.readouterr().err
    made = {"--dot": "g.dot", "--dump-if": "if.raw", "--checkpoint": "c.npz", "--resume": "c.npz"}[opt[0]]
    assert (tmp_path / made).stat().st_size > 0


def check_native(tmp_path, capsys):
    """``--native`` on an int8 AM capture 2.5 ticks long: the audio equals
    the plain file path's bit for bit, the tail included, and is within
    -80 dB of the JAX CLI's ``--native`` audio over the two whole ticks JAX
    keeps (it drops the tail, reference fault 2).  With synthetic input
    ``--native`` changes nothing: the tone decodes at 0.25; the JAX CLI
    feeds that input's packed int8 words to a cf32 chain and its audio is
    not the tone (reference fault 12)."""
    fs, tick = 2e6, 200_000
    capture = tmp_path / "am.iq"
    words = np.concatenate(list(SyntheticIqSource.am(tick, fs, 100e3, "int8", num_blocks=3)))
    words[: 5 * tick // 2].tofile(capture)
    file_args = ["--mod", "am", "--format", "int8", "--input", str(capture), "--rf-rate", "2e6",
                 "--offset", "100e3", "--duration", "2", "--tick", str(tick)]
    wavs = {k: tmp_path / f"{k}.wav" for k in ("native", "plain", "jax_native", "synth", "jax_synth")}
    assert treceive.main(file_args + ["--device", "cpu", "--native", "--audio", str(wavs["native"])]) == 0
    assert "on cpu" in capsys.readouterr().out
    assert treceive.main(file_args + ["--device", "cpu", "--audio", str(wavs["plain"])]) == 0
    assert jreceive.main(file_args + ["--platform", "cpu", "--native", "--audio", str(wavs["jax_native"])]) == 0
    synth_args = CLI_ARGS + ["--native"]
    assert treceive.main(synth_args + ["--device", "cpu", "--audio", str(wavs["synth"])]) == 0
    assert jreceive.main(synth_args + ["--platform", "cpu", "--audio", str(wavs["jax_synth"])]) == 0
    audio = {k: read_wav(w)[0] for k, w in wavs.items()}

    assert audio["native"].shape == (5 * tick // 2 * 48000 // 2_000_000,)
    np.testing.assert_array_equal(audio["native"], audio["plain"])
    ref = audio["jax_native"]
    assert ref.shape == (2 * tick * 48000 // 2_000_000,)  # JAX: no tail
    x = audio["native"][: len(ref)]
    assert 10 * np.log10(np.sum((x - ref) ** 2) / np.sum(ref**2)) <= -80.0

    amp, snr = tone_fit(audio["synth"], 48000)
    assert abs(amp - 0.25) < 0.02 and snr > 60.0, (amp, snr)
    rms = lambda a: float(np.sqrt(np.mean(a[len(a) // 3 :] ** 2)))  # noqa: E731
    assert rms(audio["synth"]) < 0.25 and rms(audio["jax_synth"]) > 0.5, (rms(audio["synth"]), rms(audio["jax_synth"]))


# -- F8: a block without buffers is placed on the card, never on the CPU by default ---


def bufferless_chain():
    """A chain that carries no taps: nothing to take a device from."""
    chain = Chain([("d", TB.QuadFmDemod(gain=1.0))])
    assert list(chain.buffers()) == []
    return chain


def test_runner_without_buffers_raises_without_a_card(monkeypatch, rng):
    """F8: without a card, a runner over a chain with no buffers raises and
    names ``device='cpu'``; with it, it runs the chain as ``apply`` does.
    (Before, it went on the CPU without a word, even on a card.)"""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    chain = bufferless_chain()
    with pytest.raises(ValueError, match="pass device='cpu'"):
        StreamRunner(chain)
    ticks = [(rng.standard_normal(512) + 1j * rng.standard_normal(512)).astype(np.complex64) for _ in range(3)]
    sink = tsinks.CollectSink()
    runner = StreamRunner(chain, device="cpu")
    runner.run(iter(ticks), sink)
    assert runner.device == torch.device("cpu") and not runner.capture
    np.testing.assert_array_equal(sink.result(), np.concatenate(chain_apply(chain, ticks)))


def test_runner_without_buffers_goes_on_the_card(monkeypatch):
    """F8: with a card (pretended here: nothing is launched) a block with no
    buffers is placed on the current CUDA device and captured; a block with
    buffers keeps their device."""
    from tpusdr_torch.graph import runner as trunner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert trunner._block_device(bufferless_chain()) == torch.device("cuda", 0)
    fir = Chain([("fir", TB.Fir(np.ones(5, np.float32), 1))])
    assert trunner._block_device(fir) == torch.device("cpu")


def test_merged_runner_and_graph_without_buffers_raise_without_a_card(monkeypatch):
    """F8 in ``MergedRunner`` (through the runner's rule) and in
    ``Graph._source_device``: no input, state tensor or buffer and no card
    raise; a CPU queue, or a state on the CPU, names the CPU."""
    from tpusdr_torch.graph import queues as tqueues
    from tpusdr_torch.graph.graph import build_graph

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="pass device='cpu'"):
        tqueues.MergedRunner({"a": bufferless_chain()})
    q = tqueues.CommandQueue("f8-cpu", "cpu")
    merged = tqueues.MergedRunner({"a": bufferless_chain()}, queue=q)
    x = torch.ones(8, dtype=torch.complex64)
    states, ys = merged.step(merged.init_state(), {"a": x})
    assert merged.devices == {"a": torch.device("cpu")} and ys["a"].device.type == "cpu"
    g = build_graph({"nodes": {"m": {"type": "Magnitude"}}, "connections": [],
                     "inputPorts": [{"exposedPort": 0, "mapped": {"node": "m", "port": 0}}], "outputPort": "m"})
    with pytest.raises(ValueError, match="no CUDA device"):
        g._source_device({}, ())
    assert g._source_device({"m": {"t": torch.zeros(1)}}, ()) == torch.device("cpu")


def test_queue_spec_without_a_type_names_the_card(monkeypatch):
    """F8 in the queue specs: no ``queueType`` resolves to the card, as
    "cuda" does, and raises without one; ``{"queueType": "cpu"}`` still
    names the CPU."""
    from tpusdr_torch.graph import queues as tqueues

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="has no queueType, so it names the card"):
        tqueues._resolve_device({})
    assert tqueues._resolve_device({"queueType": "cpu"}) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tqueues._resolve_device({}) == torch.device("cuda", 0)
    assert tqueues._resolve_device({"device": 1}) == torch.device("cuda", 1)
