"""SDR control plane: tune/gain/start/stop over a JSON side channel (port of
tpusdr/io/control.py:44-304, the same wire protocol, names and errors).

The reference's HackrfSource is not just a byte pipe: it selects a device by
index/serial (the reference's src/filters/HackrfSource.cpp:105-161) and its
``start``/``stop`` apply frequency, sample rate, and gains to the radio
(HackrfSource.cpp:263-283).  The card's host has no USB radio, so live IQ
arrives over TCP (io/sources.SocketIqSource); this module adds the control
half: a newline-delimited-JSON protocol to whatever program feeds that
socket (e.g. a hackrf_transfer shim on the RF host).

Protocol (one JSON object per line, client -> server):

    {"seq": 1, "cmd": "select", "index": 0}            # or {"serial": "..."}
    {"seq": 2, "cmd": "set_frequency", "hz": 145450000.0}
    {"seq": 3, "cmd": "set_sample_rate", "hz": 20000000.0}
    {"seq": 4, "cmd": "set_gain", "lna_db": 32, "vga_db": 20, "amp": false}
    {"seq": 5, "cmd": "start"}
    {"seq": 6, "cmd": "stop"}

Server replies ``{"seq": N, "ok": true}`` or ``{"seq": N, "ok": false,
"error": "..."}``; the client raises ``SdrControlError`` on the latter
(Status propagation parity: HackrfSource returns Status_* per call).

``SdrReceiverControl`` ties the protocol to a running stream: retuning the
radio center or hopping channels updates both the remote device and the
device-side NCO (StreamRunner.update_parameters: the block's update, then
the captured step's recapture) without dropping the stream.
"""

from __future__ import annotations

import json
import socket
import socketserver
import threading
from typing import Any, Callable, Mapping

from tpusdr_torch.utils.logging import get_logger

log = get_logger("io.control")

#: commands a conforming server must implement (the HackrfSource surface:
#: device select :105-161; start/stop applying freq/rate/gain :263-283).
COMMANDS = ("select", "set_frequency", "set_sample_rate", "set_gain",
            "start", "stop", "ping")


class SdrControlError(RuntimeError):
    """Server-reported command failure (Status_* parity)."""


class SdrControlClient:
    """JSON-over-TCP control client for a remote SDR front end."""

    def __init__(self, host: str, port: int, timeout_s: float = 5.0):
        self.addr = (host, port)
        self.timeout_s = timeout_s
        self._sock = socket.create_connection(self.addr, timeout=timeout_s)
        self._sock.settimeout(timeout_s)
        self._rfile = self._sock.makefile("r", encoding="utf-8")
        self._seq = 0
        self._lock = threading.Lock()

    # -- transport ----------------------------------------------------------

    def _call(self, cmd: str, **params) -> Mapping[str, Any]:
        with self._lock:
            self._seq += 1
            seq = self._seq
            msg = {"seq": seq, "cmd": cmd, **params}
            self._sock.sendall((json.dumps(msg) + "\n").encode("utf-8"))
            line = self._rfile.readline()
            if not line:
                raise SdrControlError(f"control connection closed during {cmd!r}")
            reply = json.loads(line)
        if reply.get("seq") != seq:
            raise SdrControlError(
                f"out-of-order control reply: sent seq {seq}, got {reply}"
            )
        if not reply.get("ok", False):
            raise SdrControlError(
                f"{cmd} failed: {reply.get('error', 'unknown error')}"
            )
        return reply

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- the HackrfSource control surface ------------------------------------

    def select_device(self, index: int | None = None, serial: str | None = None):
        """Device select by index or serial (HackrfSource.cpp:105-161)."""
        if (index is None) == (serial is None):
            raise ValueError("pass exactly one of index= or serial=")
        params = {"index": int(index)} if index is not None else {"serial": serial}
        return self._call("select", **params)

    def set_frequency(self, hz: float):
        return self._call("set_frequency", hz=float(hz))

    def set_sample_rate(self, hz: float):
        return self._call("set_sample_rate", hz=float(hz))

    def set_gain(
        self,
        lna_db: float | None = None,
        vga_db: float | None = None,
        amp: bool | None = None,
    ):
        """LNA/VGA/amp gains (hackrf_set_lna_gain/vga_gain/amp_enable,
        HackrfSource.cpp:271-277)."""
        params = {}
        if lna_db is not None:
            params["lna_db"] = float(lna_db)
        if vga_db is not None:
            params["vga_db"] = float(vga_db)
        if amp is not None:
            params["amp"] = bool(amp)
        if not params:
            raise ValueError("set_gain needs at least one of lna_db/vga_db/amp")
        return self._call("set_gain", **params)

    def start(self):
        """Begin RX streaming (hackrf_start_rx, HackrfSource.cpp:279-283)."""
        return self._call("start")

    def stop(self):
        return self._call("stop")

    def ping(self):
        return self._call("ping")


class SdrControlServer:
    """Threaded control server skeleton.

    Runs the wire protocol and dispatches each command to ``handler``
    (a callable ``handler(cmd: str, params: dict) -> Any``; raise to report
    failure).  A handler returning a Mapping has its fields merged into the
    reply — that is how the RF-host shim reports ``stream_pos`` (the data
    stream byte position at which a retune took effect, the currency of the
    retune-flush protocol — io/shim.py).  Used by the test stubs and by the
    runnable shim (tpusdr_torch.apps.rf_shim) wrapping a fake or real driver.
    """

    def __init__(self, handler: Callable[[str, dict], Any], host="127.0.0.1",
                 port: int = 0):
        self.handler = handler
        outer = self

        class _Handler(socketserver.StreamRequestHandler):
            def handle(self):
                for raw in self.rfile:
                    seq = None
                    try:
                        msg = json.loads(raw)
                        seq = msg.get("seq")
                        cmd = msg.get("cmd")
                        if cmd not in COMMANDS:
                            raise ValueError(f"unknown command {cmd!r}")
                        params = {
                            k: v for k, v in msg.items() if k not in ("seq", "cmd")
                        }
                        result = outer.handler(cmd, params)
                        reply = dict(result) if isinstance(result, Mapping) else {}
                        reply.update({"seq": seq, "ok": True})
                    except Exception as e:  # report, don't kill the session
                        reply = {"seq": seq, "ok": False, "error": str(e)}
                    self.wfile.write((json.dumps(reply) + "\n").encode("utf-8"))

        self._server = socketserver.ThreadingTCPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )

    def start(self) -> "SdrControlServer":
        self._thread.start()
        log.info("SDR control server on port %d", self.port)
        return self

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()


class SdrReceiverControl:
    """Retune-while-streaming: one object tying the remote radio (control
    client) to the on-device receiver chain (StreamRunner).

    The receiver chain demodulates the channel at ``channel_hz`` out of a
    capture centered at ``center_hz``; the NCO shift is
    ``-(channel_hz - center_hz)`` (models/receiver.py convention).  Two
    moves keep the audio flowing across a retune:

      * ``tune_channel(hz)`` — hop to another channel inside the current
        capture bandwidth: device-side only (update the shift NCO, recapture).
      * ``tune_radio(hz, channel_hz=None)`` — move the radio center
        (control command) AND re-aim the NCO at the (possibly new) channel,
        flushing in-flight IQ captured at the old center (see below).

    ``shift_block``: name of the FreqShift/FreqShiftFir stage in the chain
    (models/receiver.py names it "shift"/"shiftfir"/"shiftfir1").

    ``source``: the SocketIqSource feeding the runner.  When given and the
    control server reports ``stream_pos`` in its set_frequency reply (the
    RF-host shim does, io/shim.py), ``tune_radio`` discards every data-
    stream byte before that position — otherwise samples captured at the
    old center still sitting in TCP buffers / the ingest queue would be
    demodulated with the new NCO.  The reference gets the same clean cut
    from stop/start framing (HackrfSource.cpp:263-283).
    """

    def __init__(
        self,
        client: SdrControlClient,
        runner,
        center_hz: float,
        channel_hz: float,
        shift_block: str | None = None,
        source=None,
    ):
        self.client = client
        self.runner = runner
        self.source = source
        self.center_hz = float(center_hz)
        self.channel_hz = float(channel_hz)
        if shift_block is None:
            names = [n for n, _ in runner.block.blocks]
            cands = [n for n in names if n.startswith(("shift", "shiftfir"))]
            if not cands:
                raise ValueError(
                    f"no shift stage found in chain {names}; pass shift_block="
                )
            shift_block = cands[0]
        self.shift_block = shift_block

    @property
    def offset_hz(self) -> float:
        return self.channel_hz - self.center_hz

    def _apply_shift(self) -> None:
        self.runner.update_parameters(
            self.shift_block, frequency=-self.offset_hz
        )

    def tune_channel(self, channel_hz: float) -> None:
        """Hop channels within the capture band — no radio command, one
        NCO parameter update + recapture; phase stays continuous."""
        self.channel_hz = float(channel_hz)
        self._apply_shift()
        log.info(
            "channel -> %.6g Hz (offset %.6g)", self.channel_hz, self.offset_hz
        )

    def tune_radio(self, center_hz: float, channel_hz: float | None = None) -> None:
        """Retune the radio center (HackrfSource start/stop freq surface)
        and re-aim the device-side NCO in the same move, flushing IQ
        captured at the old center out of the ingest path."""
        reply = self.client.set_frequency(center_hz)
        if self.source is not None:
            pos = reply.get("stream_pos")
            if pos is not None and hasattr(self.source, "skip_until_byte"):
                self.source.skip_until_byte(int(pos))
            else:
                log.warning(
                    "retune without stream_pos/skip support: in-flight IQ "
                    "captured at the old center will reach the demodulator"
                )
        self.center_hz = float(center_hz)
        if channel_hz is not None:
            self.channel_hz = float(channel_hz)
        self._apply_shift()
        log.info(
            "radio -> %.6g Hz, channel %.6g (offset %.6g)",
            self.center_hz,
            self.channel_hz,
            self.offset_hz,
        )

    def set_gain(self, **kw) -> None:
        self.client.set_gain(**kw)

    def start(self) -> None:
        self.client.start()

    def stop(self) -> None:
        self.client.stop()
