"""RF-host shim: the runnable program that stands where the reference's
HackrfSource + HackrfSession stood (port of tpusdr/io/shim.py:48-471;
numpy and sockets only).

The card's host has no USB radio, so the radio lives on a separate RF host and
this shim runs THERE, next to the hardware: it implements the control
COMMANDS (io/control.py — device select by index/serial, freq/rate/gain,
start/stop, exactly the libhackrf surface of
the reference's src/filters/HackrfSource.cpp:105-161, 263-283 and the
process-wide session handling of src/HackrfSession.cpp:43-94) and pushes
interleaved int8 IQ to a data socket that a SocketIqSource on the
receiver's host consumes.

Driver backends plug in behind a 6-method pull protocol (``SdrDriver``):

  * ``FakeSdrDriver`` — a deterministic synthetic radio (CW / FM stations
    at absolute RF frequencies) for CI and development; retuning the
    center frequency moves the stations' observed offsets exactly as real
    hardware would.
  * ``SoapySdrDriver`` — a thin SoapySDR wrapper for real hardware
    (HackRF, RTL-SDR, ...), import-gated: CI has no SoapySDR and no
    radio, so it raises with instructions unless the module is present.

Retune-flush protocol: every data byte the shim writes is counted; the
``set_frequency`` handler applies the new frequency and snapshots that
counter ATOMICALLY with respect to the pump loop, and returns it as
``stream_pos`` in the reply.  Bytes before ``stream_pos`` were captured at
the old center; the consumer (SdrReceiverControl.tune_radio ->
SocketIqSource.skip_until_byte) discards them so they are never
demodulated with the re-aimed NCO.  The reference achieves the same cut by
stopping RX, retuning, and restarting (HackrfSource.cpp:263-283); the
counter gives the identical boundary without tearing down the stream.
"""

from __future__ import annotations

import threading
import time
from typing import Mapping, Sequence

import numpy as np

from tpusdr_torch.io.control import SdrControlServer
from tpusdr_torch.utils.logging import get_logger

log = get_logger("io.shim")


class SdrDriver:
    """Pull-based driver protocol the shim pumps.

    ``read_block()`` returns the next ``block_samples`` complex samples as
    interleaved int8 IQ bytes at the current center/rate/gain.  Push-based
    hardware APIs (the libhackrf RX callback) adapt with a bounded queue in
    front of read_block — the BufferPool role, HackrfSource.cpp:175-201.
    """

    def enumerate(self) -> list[dict]:
        raise NotImplementedError

    def open(self, index: int | None = None, serial: str | None = None) -> None:
        raise NotImplementedError

    def set_frequency(self, hz: float) -> None:
        raise NotImplementedError

    def set_sample_rate(self, hz: float) -> None:
        raise NotImplementedError

    def set_gain(self, lna_db=None, vga_db=None, amp=None) -> None:
        raise NotImplementedError

    def read_block(self) -> bytes:
        raise NotImplementedError

    def close(self) -> None:
        pass


class Station:
    """One synthetic emitter at an absolute RF frequency.

    kind 'cw' is a pure carrier; 'fm' is an FM carrier modulated by a
    single audio tone (``audio_hz``, ``deviation``) — enough to drive the
    full receive chain end-to-end and hear the retune.
    """

    def __init__(
        self,
        freq_hz: float,
        kind: str = "cw",
        amplitude: float = 0.5,
        audio_hz: float = 1000.0,
        deviation: float = 75e3,
    ):
        if kind not in ("cw", "fm"):
            raise ValueError(f"unknown station kind {kind!r}")
        self.freq_hz = float(freq_hz)
        self.kind = kind
        self.amplitude = float(amplitude)
        self.audio_hz = float(audio_hz)
        self.deviation = float(deviation)

    @staticmethod
    def parse(spec: str) -> "Station":
        """CLI form: 'FREQ[:KIND[:AUDIO_HZ]]', e.g. '100.1e6:fm:1000'."""
        parts = spec.split(":")
        st = Station(float(parts[0]))
        if len(parts) > 1:
            st.kind = parts[1]
            if st.kind not in ("cw", "fm"):
                raise ValueError(f"unknown station kind {st.kind!r}")
        if len(parts) > 2:
            st.audio_hz = float(parts[2])
        return st


class FakeSdrDriver(SdrDriver):
    """Deterministic synthetic radio for CI / development.

    Emits the sum of the configured stations observed from the current
    center frequency (station at f appears at baseband offset f - center),
    quantized to interleaved int8 IQ — the HackRF wire format.  Phase is
    continuous across blocks and retunes (a global sample counter drives
    every oscillator), so the only discontinuity a retune produces is the
    frequency step itself, exactly like hardware.
    """

    def __init__(
        self,
        stations: Sequence[Station] = (),
        block_samples: int = 16384,
        serials: Sequence[str] = ("fake-0001",),
        realtime: bool = False,
        noise: float = 0.0,
        seed: int = 0,
    ):
        self.stations = list(stations)
        self.block = int(block_samples)
        self.serials = list(serials)
        self.realtime = realtime
        self.noise = float(noise)
        self._rng = np.random.default_rng(seed)
        self.center_hz = 100e6
        self.fs = 10e6
        self.lna_db = 32.0
        self.vga_db = 8.0
        self.amp = False
        self._n = 0  # global sample counter (phase continuity)
        self._opened: str | None = None
        self._fm_phase = [0.0] * len(self.stations)

    # -- control surface (HackrfSource.cpp:105-161, 263-283) ---------------

    def enumerate(self) -> list[dict]:
        return [{"index": i, "serial": s} for i, s in enumerate(self.serials)]

    def open(self, index: int | None = None, serial: str | None = None) -> None:
        if serial is not None:
            if serial not in self.serials:
                raise ValueError(f"no device with serial {serial!r}")
            self._opened = serial
        elif index is not None:
            if not 0 <= int(index) < len(self.serials):
                raise ValueError(f"device index {index} out of range")
            self._opened = self.serials[int(index)]
        else:
            raise ValueError("pass index or serial")
        log.info("fake driver: opened %s", self._opened)

    def set_frequency(self, hz: float) -> None:
        self.center_hz = float(hz)

    def set_sample_rate(self, hz: float) -> None:
        self.fs = float(hz)

    def set_gain(self, lna_db=None, vga_db=None, amp=None) -> None:
        if lna_db is not None:
            self.lna_db = float(lna_db)
        if vga_db is not None:
            self.vga_db = float(vga_db)
        if amp is not None:
            self.amp = bool(amp)

    # -- sample generation ---------------------------------------------------

    def read_block(self) -> bytes:
        if self._opened is None:
            raise RuntimeError("no device opened (send select first)")
        n = self.block
        t = (self._n + np.arange(n)) / self.fs
        z = np.zeros(n, np.complex128)
        for i, st in enumerate(self.stations):
            off = st.freq_hz - self.center_hz
            if abs(off) > self.fs / 2:
                continue  # outside the capture bandwidth
            if st.kind == "cw":
                z += st.amplitude * np.exp(2j * np.pi * off * t)
            else:  # fm: phase integral of the audio tone, continuous state
                audio = np.sin(2 * np.pi * st.audio_hz * t)
                dphi = 2 * np.pi * st.deviation * audio / self.fs
                phase = self._fm_phase[i] + np.cumsum(dphi)
                self._fm_phase[i] = float(phase[-1])
                z += st.amplitude * np.exp(
                    1j * (2 * np.pi * off * t + phase)
                )
        if self.noise > 0:
            z += self.noise * (
                self._rng.standard_normal(n) + 1j * self._rng.standard_normal(n)
            )
        # gain: unity at the (32, 8) defaults, +/-1 dB per dB around it
        scale = 10.0 ** ((self.lna_db + self.vga_db - 40.0) / 20.0)
        z *= scale
        self._n += n
        inter = np.empty(2 * n, np.float32)
        inter[0::2] = z.real
        inter[1::2] = z.imag
        return (
            np.clip(np.round(inter * 127.0), -128, 127).astype(np.int8).tobytes()
        )

    def pace_seconds(self) -> float:
        """Realtime pacing budget per block.  The SHIM sleeps this outside
        its stream lock (sleeping inside read_block would hold the lock
        across the pace and starve the control/accept threads — observed
        as a consumer that never attaches)."""
        return self.block / self.fs if self.realtime else 0.0


class SoapySdrDriver(SdrDriver):
    """Real-hardware backend via SoapySDR (covers HackRF through
    soapy-hackrf).  Import-gated: this image has no SoapySDR and no radio,
    so the class exists as the documented hook — construction fails with
    instructions unless the module is importable.  The mapping is direct:
    enumerate -> SoapySDR.Device.enumerate(), open -> Device(args),
    set_frequency/sample_rate/gain -> setFrequency/setSampleRate/setGain,
    read_block -> readStream into int16 CS16 then narrowed to int8 IQ.
    """

    def __init__(self, driver_args: str = "", block_samples: int = 1 << 17):
        try:
            import SoapySDR  # noqa: F401
        except ImportError as e:  # pragma: no cover - no SDR stack in CI
            raise ImportError(
                "SoapySdrDriver needs the SoapySDR python module (install "
                "soapysdr + a hardware plugin, e.g. soapy-hackrf, on the RF "
                "host). For CI / development use FakeSdrDriver."
            ) from e
        self._soapy = SoapySDR
        self.driver_args = driver_args
        self.block = int(block_samples)
        self._dev = None
        self._stream = None

    def enumerate(self) -> list[dict]:  # pragma: no cover - hardware only
        return [dict(kw) for kw in self._soapy.Device.enumerate(self.driver_args)]

    def open(self, index=None, serial=None) -> None:  # pragma: no cover
        found = self.enumerate()
        if serial is not None:
            match = [kw for kw in found if kw.get("serial") == serial]
            if not match:
                raise ValueError(f"no device with serial {serial!r}")
            kw = match[0]
        else:
            kw = found[int(index or 0)]
        self._dev = self._soapy.Device(kw)

    def set_frequency(self, hz) -> None:  # pragma: no cover
        self._dev.setFrequency(self._soapy.SOAPY_SDR_RX, 0, float(hz))

    def set_sample_rate(self, hz) -> None:  # pragma: no cover
        self._dev.setSampleRate(self._soapy.SOAPY_SDR_RX, 0, float(hz))

    def set_gain(self, lna_db=None, vga_db=None, amp=None):  # pragma: no cover
        if lna_db is not None:
            self._dev.setGain(self._soapy.SOAPY_SDR_RX, 0, "LNA", float(lna_db))
        if vga_db is not None:
            self._dev.setGain(self._soapy.SOAPY_SDR_RX, 0, "VGA", float(vga_db))
        if amp is not None:
            self._dev.setGain(
                self._soapy.SOAPY_SDR_RX, 0, "AMP", 14.0 if amp else 0.0
            )

    def read_block(self) -> bytes:  # pragma: no cover - hardware only
        import SoapySDR as S

        if self._stream is None:
            self._stream = self._dev.setupStream(S.SOAPY_SDR_RX, S.SOAPY_SDR_CS8)
            self._dev.activateStream(self._stream)
        out = np.empty(2 * self.block, np.int8)
        got = 0
        while got < self.block:
            sr = self._dev.readStream(
                self._stream, [out[2 * got :]], self.block - got
            )
            if sr.ret <= 0:
                raise RuntimeError(f"readStream error {sr.ret}")
            got += sr.ret
        return out.tobytes()


class RfShim:
    """The runnable shim: control server + data pump over one driver.

    One data consumer at a time (one radio feeds one pipeline, the
    reference's model); the byte ledger that backs ``stream_pos`` is
    per-connection, reset when a new consumer attaches.
    """

    def __init__(
        self,
        driver: SdrDriver,
        host: str = "127.0.0.1",
        control_port: int = 0,
        data_port: int = 0,
    ):
        import socket as _socket

        self.driver = driver
        self._lock = threading.RLock()  # orders pump vs control atomically
        self._stop = threading.Event()
        self._pump_thread: threading.Thread | None = None
        self._client_sock = None
        #: lock-free handoff accept thread -> pump: the accept thread must
        #: never contend for _lock (a blocking driver read or pacing could
        #: starve it); plain attribute stores are atomic under the GIL
        self._pending_client = None
        self.bytes_sent = 0
        self.started = False

        self._data_srv = _socket.socket(_socket.AF_INET, _socket.SOCK_STREAM)
        self._data_srv.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEADDR, 1)
        self._data_srv.bind((host, data_port))
        self._data_srv.listen(1)
        self.data_port = self._data_srv.getsockname()[1]

        self._control = SdrControlServer(self._handle, host=host,
                                         port=control_port)
        self.control_port = self._control.port
        self._accept_thread = threading.Thread(target=self._accept, daemon=True)

    # -- data side ------------------------------------------------------------

    def _accept(self) -> None:
        while not self._stop.is_set():
            try:
                sock, addr = self._data_srv.accept()
            except OSError:
                return
            if self._client_sock is not None or self._pending_client is not None:
                log.warning("second data consumer from %s rejected", addr)
                sock.close()
                continue
            self._pending_client = sock  # pump attaches it (lock-free handoff)
            log.info("data consumer connected from %s", addr)

    def _pump(self) -> None:
        while not self._stop.is_set() and self.started:
            t_iter = time.perf_counter()
            # The whole generate+send+count step holds the lock so a
            # set_frequency can never land between a block's generation (at
            # the old center) and its accounting — stream_pos is exact.
            with self._lock:
                if not self.started:
                    return
                if self._pending_client is not None:
                    self._client_sock = self._pending_client
                    self._pending_client = None
                    self.bytes_sent = 0  # fresh ledger per connection
                try:
                    block = self.driver.read_block()
                except Exception as e:
                    # driver fault = device unplug: stop streaming, keep the
                    # control plane up so the client sees the error on the
                    # next command (HackrfSource read-timeout analog)
                    log.error("driver read failed, stopping stream: %s", e)
                    self.started = False
                    return
                sock = self._client_sock
                if sock is not None:
                    try:
                        sock.sendall(block)
                        self.bytes_sent += len(block)
                    except OSError:
                        log.info("data consumer disconnected")
                        sock.close()
                        self._client_sock = None
            # pacing and idle sleeps happen OUTSIDE the lock: holding it
            # across a sleep starves the control handlers
            pace = getattr(self.driver, "pace_seconds", lambda: 0.0)()
            if pace > 0:
                time.sleep(max(0.0, pace - (time.perf_counter() - t_iter)))
            elif self._client_sock is None:
                time.sleep(0.005)  # idle: don't spin flat out with no consumer

    # -- control side (the COMMANDS surface) -----------------------------------

    def _handle(self, cmd: str, params: dict) -> Mapping | None:
        if cmd == "ping":
            return {"devices": self.driver.enumerate()}
        if cmd == "select":
            self.driver.open(
                index=params.get("index"), serial=params.get("serial")
            )
            return None
        if cmd == "set_frequency":
            with self._lock:
                self.driver.set_frequency(params["hz"])
                # every byte before this position was captured at the old
                # center — the consumer's flush boundary
                return {"stream_pos": self.bytes_sent}
        if cmd == "set_sample_rate":
            with self._lock:
                self.driver.set_sample_rate(params["hz"])
                return {"stream_pos": self.bytes_sent}
        if cmd == "set_gain":
            with self._lock:
                self.driver.set_gain(
                    lna_db=params.get("lna_db"),
                    vga_db=params.get("vga_db"),
                    amp=params.get("amp"),
                )
            return None
        if cmd == "start":
            with self._lock:
                if self.started:
                    return None
                self.started = True
            self._pump_thread = threading.Thread(target=self._pump, daemon=True)
            self._pump_thread.start()
            return None
        if cmd == "stop":
            with self._lock:
                self.started = False
            return None
        raise ValueError(f"unhandled command {cmd!r}")

    # -- lifecycle --------------------------------------------------------------

    def start(self) -> "RfShim":
        self._control.start()
        self._accept_thread.start()
        log.info(
            "rf shim up: control port %d, data port %d",
            self.control_port,
            self.data_port,
        )
        return self

    def close(self) -> None:
        self._stop.set()
        self.started = False
        self._control.close()
        try:
            self._data_srv.close()
        except OSError:
            pass
        with self._lock:
            for attr in ("_client_sock", "_pending_client"):
                sock = getattr(self, attr)
                if sock is not None:
                    sock.close()
                    setattr(self, attr, None)
        if self._pump_thread is not None:
            self._pump_thread.join(timeout=2.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
