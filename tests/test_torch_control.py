"""The port's SDR control plane (tpusdr_torch/io/control.py), case for case
with tests/test_control.py, and against the JAX package's.

The HackrfSource control surface against a stub server that records the
command sequence, and retune-while-streaming through the port's
StreamRunner.update_parameters.  Tolerances: the channel hop's post-hop
output within 1e-5 of a fresh chain resuming the carried state (the same
ops on other tensors), and within 1e-5 of the JAX runner's output after
the same hop (float32 both; the NCO and FIR differ by rounding).
"""

import numpy as np
import pytest
import scipy.signal as sps
import torch
from torch.utils import _pytree as pytree

from tpusdr.graph import blocks as JB
from tpusdr.graph.chain import Chain as JChain
from tpusdr.graph.runner import StreamRunner as JRunner
from tpusdr.io import control as jcontrol
from tpusdr.io.sinks import CollectSink as JCollectSink
from tpusdr_torch.graph import blocks as B
from tpusdr_torch.graph.chain import Chain
from tpusdr_torch.graph.runner import StreamRunner
from tpusdr_torch.io.control import (
    COMMANDS,
    SdrControlClient,
    SdrControlError,
    SdrControlServer,
    SdrReceiverControl,
)
from tpusdr_torch.io.sinks import CollectSink
from tpusdr_torch.models import receiver

torch.set_num_threads(1)


class RecordingHandler:
    def __init__(self, fail_on=()):
        self.calls = []
        self.fail_on = set(fail_on)

    def __call__(self, cmd, params):
        if cmd in self.fail_on:
            raise RuntimeError(f"injected failure for {cmd}")
        self.calls.append((cmd, params))


@pytest.fixture
def server():
    handler = RecordingHandler()
    with SdrControlServer(handler) as srv:
        yield srv, handler


class TestControlProtocol:
    def test_command_sequence(self, server):
        """The full HackrfSource bring-up sequence, asserted in order."""
        srv, handler = server
        with SdrControlClient("127.0.0.1", srv.port) as c:
            c.select_device(serial="0000aabb")
            c.set_frequency(145.45e6)
            c.set_sample_rate(20e6)
            c.set_gain(lna_db=32, vga_db=20, amp=False)
            c.start()
            c.stop()
        assert handler.calls == [
            ("select", {"serial": "0000aabb"}),
            ("set_frequency", {"hz": 145.45e6}),
            ("set_sample_rate", {"hz": 20e6}),
            ("set_gain", {"lna_db": 32.0, "vga_db": 20.0, "amp": False}),
            ("start", {}),
            ("stop", {}),
        ]

    def test_select_by_index(self, server):
        srv, handler = server
        with SdrControlClient("127.0.0.1", srv.port) as c:
            c.select_device(index=1)
        assert handler.calls == [("select", {"index": 1})]

    def test_select_validates_args(self, server):
        srv, _ = server
        with SdrControlClient("127.0.0.1", srv.port) as c:
            with pytest.raises(ValueError, match="exactly one"):
                c.select_device()
            with pytest.raises(ValueError, match="exactly one"):
                c.select_device(index=0, serial="x")

    def test_server_error_raises(self):
        handler = RecordingHandler(fail_on={"set_frequency"})
        with SdrControlServer(handler) as srv:
            with SdrControlClient("127.0.0.1", srv.port) as c:
                with pytest.raises(SdrControlError, match="injected failure"):
                    c.set_frequency(1e6)
                # session survives a failed command (Status, not abort)
                c.ping()

    def test_unknown_command_rejected(self, server):
        srv, _ = server
        with SdrControlClient("127.0.0.1", srv.port) as c:
            with pytest.raises(SdrControlError, match="unknown command"):
                c._call("warp_drive")

    def test_wire_protocol_interoperates_with_jax(self):
        """The same protocol both ways: the port's client against the JAX
        server and the JAX client against the port's server."""
        assert COMMANDS == jcontrol.COMMANDS
        for Server, Client in ((jcontrol.SdrControlServer, SdrControlClient),
                               (SdrControlServer, jcontrol.SdrControlClient)):
            handler = RecordingHandler(fail_on={"stop"})
            with Server(handler) as srv:
                with Client("127.0.0.1", srv.port) as c:
                    c.select_device(index=2)
                    c.set_gain(vga_db=12)
                    with pytest.raises(RuntimeError, match="injected failure for stop"):
                        c.stop()
            assert handler.calls == [("select", {"index": 2}), ("set_gain", {"vga_db": 12.0})]


def tone_blocks(fs, f, n, blocks, start=0):
    out = []
    for b in range(blocks):
        t = (np.arange(n) + start + b * n) / fs
        out.append(np.exp(2j * np.pi * f * t).astype(np.complex64))
    return out


TAPS = sps.firwin(33, 0.2).astype(np.float32)


def clone_state(state):
    return pytree.tree_map(lambda t: t.clone(), state)


class TestRetuneWhileStreaming:
    def _chain(self, fs, offset):
        return Chain([("shift", B.FreqShift(fs, -offset)), ("fir", B.Fir(TAPS, 4))])

    def test_channel_hop_mid_stream(self, server):
        """Retune to a second channel mid-stream: the radio gets no command
        (same capture), the NCO is re-aimed, the stream never stops, and
        post-hop output matches a chain built at the new offset resuming
        from the carried state."""
        srv, handler = server
        fs = 1e6
        f1, f2 = 150e3, -200e3
        center = 100e6
        n = 4096

        chain = self._chain(fs, f1)
        runner = StreamRunner(chain)
        client = SdrControlClient("127.0.0.1", srv.port)
        ctl = SdrReceiverControl(client, runner, center_hz=center, channel_hz=center + f1)
        assert ctl.shift_block == "shift"

        sink1 = CollectSink()
        state, _ = runner.run(iter(tone_blocks(fs, f1, n, 2)), sink1)
        # tone at the tuned channel lands at DC post-shift: flat magnitude
        steady = sink1.result()[..., 512:]
        assert np.abs(np.abs(steady) - np.abs(steady).mean()).max() < 1e-2

        state_save = clone_state(state)
        ctl.tune_channel(center + f2)
        assert handler.calls == []  # no radio command for an in-band hop

        sink2 = CollectSink()
        blocks2 = tone_blocks(fs, f2, n, 2, start=2 * n)
        state, _ = runner.run(iter(blocks2), sink2, state=state)
        got = sink2.result()

        # reference: fresh chain at the new offset resuming the saved state
        ref_chain = self._chain(fs, f2)
        s = state_save
        outs = []
        for b in blocks2:
            s, y = ref_chain.apply(s, torch.from_numpy(b))
            outs.append(y.numpy())
        np.testing.assert_allclose(got, np.concatenate(outs), atol=1e-5)
        client.close()

    def test_channel_hop_equals_jax(self, server):
        """The same hop on the same seeded blocks through the JAX runner and
        its SdrReceiverControl: the port's output within 1e-5 of JAX's,
        before and after the hop."""
        srv, _ = server
        fs, n, center = 1e6, 4096, 100e6
        f1, f2 = 150e3, -200e3
        rng = np.random.default_rng(7)
        noise = [(0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
                 for _ in range(4)]
        blocks = [b + w for b, w in zip(tone_blocks(fs, f1, n, 2) + tone_blocks(fs, f2, n, 2, start=2 * n), noise)]

        outs = {}
        for name in ("port", "jax"):
            if name == "port":
                runner = StreamRunner(self._chain(fs, f1))
                client, Control, Sink = SdrControlClient("127.0.0.1", srv.port), SdrReceiverControl, CollectSink
            else:
                chain = JChain([("shift", JB.FreqShift(fs, -f1)), ("fir", JB.Fir(TAPS, 4))])
                runner = JRunner(chain, donate_state=False)
                client = jcontrol.SdrControlClient("127.0.0.1", srv.port)
                Control, Sink = jcontrol.SdrReceiverControl, JCollectSink
            ctl = Control(client, runner, center_hz=center, channel_hz=center + f1)
            pre, post = Sink(), Sink()
            state, _ = runner.run(iter(blocks[:2]), pre)
            ctl.tune_channel(center + f2)
            runner.run(iter(blocks[2:]), post, state=state)
            outs[name] = (pre.result(), post.result())
            client.close()
        for ours, theirs in zip(outs["port"], outs["jax"]):
            theirs = np.asarray(theirs)
            assert ours.shape == theirs.shape == (2 * n // 4,)
            np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-5)

    def test_radio_retune_sends_command(self, server):
        srv, handler = server
        fs = 1e6
        chain = self._chain(fs, 100e3)
        runner = StreamRunner(chain)
        client = SdrControlClient("127.0.0.1", srv.port)
        ctl = SdrReceiverControl(client, runner, center_hz=100e6, channel_hz=100.1e6)
        ctl.tune_radio(101e6, channel_hz=101.2e6)
        assert handler.calls == [("set_frequency", {"hz": 101e6})]
        assert ctl.offset_hz == pytest.approx(0.2e6)
        assert chain.get_block("shift").frequency == pytest.approx(-0.2e6)
        client.close()

    def test_missing_shift_stage_rejected(self, server):
        srv, _ = server
        chain = Chain([("fir", B.Fir(sps.firwin(9, 0.3).astype(np.float32), 1))])
        runner = StreamRunner(chain)
        client = SdrControlClient("127.0.0.1", srv.port)
        with pytest.raises(ValueError, match="no shift stage"):
            SdrReceiverControl(client, runner, 1e6, 1.1e6)
        client.close()

    @pytest.mark.parametrize("build, stage", [
        (lambda: receiver.fm_receiver(2e6, 300e3, receiver.WBFM), "shiftfir"),
        (lambda: receiver.fm_receiver(2e6, 300e3, receiver.WBFM, fold_shift=False), "shift"),
        (lambda: receiver.am_receiver(20e6, 300e3), "shiftfir1"),
        (lambda: receiver.fm_receiver(2e6, 300e3, receiver.WBFM, use_fused=True), None),
    ])
    def test_shift_stage_of_the_receivers(self, server, build, stage):
        """The lookup finds each receiver's shift stage and re-aims it; the
        fused front end ``frontend`` is not one (as in JAX)."""
        srv, _ = server
        chain, _ = build()
        runner = StreamRunner(chain)
        with SdrControlClient("127.0.0.1", srv.port) as client:
            if stage is None:
                with pytest.raises(ValueError, match="no shift stage"):
                    SdrReceiverControl(client, runner, 100e6, 100.3e6)
                return
            ctl = SdrReceiverControl(client, runner, 100e6, 100.3e6)
            assert ctl.shift_block == stage
            ctl.tune_channel(100.2e6)
            assert chain.get_block(stage).frequency == pytest.approx(-0.2e6)
