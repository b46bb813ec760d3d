"""The port's SoapySdrDriver (tpusdr_torch/io/shim.py) exercised end to end
under a fake SoapySDR module, case for case with tests/test_soapy_mock.py.

The real-hardware driver path cannot run without a radio, so API drift or
a typo would ship silently.  This suite injects a mock ``SoapySDR`` module via
``sys.modules`` and drives the FULL surface the reference battle-tests in
HackrfSource.cpp: device enumerate + select by index/serial (:105-161),
tuning/gain (:263-283), and the blocking read loop with short reads
(:284-318) — including the shim pump integration (driver -> data socket
-> SocketIqSource), with no hardware and no SoapySDR install.

The mock mirrors the real SoapySDR python API shapes: Device.enumerate()
returns kwargs-dicts, Device(kwargs) opens, readStream(stream, [buf], n)
returns an object with ``.ret`` (samples read, or a negative error code)
and fills the buffer with interleaved CS8 bytes.
"""

import sys
import time
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

SOAPY_SDR_RX = 1
SOAPY_SDR_CS8 = "CS8"


class _StreamResult:
    def __init__(self, ret: int):
        self.ret = ret


class _MockStream:
    pass


class _MockDevice:
    """One fake radio.  Class-level config lets tests tweak behavior."""

    # devices the static enumerate() reports
    DEVICES = [
        {"driver": "hackrf", "serial": "mock-0001"},
        {"driver": "hackrf", "serial": "mock-0002"},
    ]
    # cap on samples returned per readStream call (forces the short-read loop)
    MAX_READ = 100
    # after this many successful reads, return this error code (None = never)
    FAIL_AFTER: int | None = None
    FAIL_CODE = -1  # SOAPY_SDR_TIMEOUT
    instances: list["_MockDevice"] = []

    @staticmethod
    def enumerate(args=""):
        return list(_MockDevice.DEVICES)

    def __init__(self, kwargs):
        self.kwargs = dict(kwargs)
        self.calls: list[tuple] = []
        self._counter = 0  # CS8 byte ramp for payload verification
        self._reads = 0
        self._active = False
        _MockDevice.instances.append(self)

    def setFrequency(self, direction, channel, hz):
        self.calls.append(("setFrequency", direction, channel, hz))

    def setSampleRate(self, direction, channel, hz):
        self.calls.append(("setSampleRate", direction, channel, hz))

    def setGain(self, direction, channel, name, value):
        self.calls.append(("setGain", direction, channel, name, value))

    def setupStream(self, direction, fmt):
        self.calls.append(("setupStream", direction, fmt))
        assert fmt == SOAPY_SDR_CS8
        return _MockStream()

    def activateStream(self, stream):
        self.calls.append(("activateStream",))
        self._active = True

    def readStream(self, stream, buffs, numElems, *a, **kw):
        assert self._active, "readStream before activateStream"
        self._reads += 1
        if self.FAIL_AFTER is not None and self._reads > self.FAIL_AFTER:
            return _StreamResult(self.FAIL_CODE)
        n = min(int(numElems), self.MAX_READ)
        ramp = (np.arange(2 * n) + self._counter) % 256 - 128
        buffs[0][: 2 * n] = ramp.astype(np.int8)
        self._counter += 2 * n
        return _StreamResult(n)


@pytest.fixture
def soapy(monkeypatch):
    """Inject the mock SoapySDR module; yields the mock Device class."""
    mod = types.ModuleType("SoapySDR")
    mod.SOAPY_SDR_RX = SOAPY_SDR_RX
    mod.SOAPY_SDR_CS8 = SOAPY_SDR_CS8
    mod.Device = _MockDevice
    monkeypatch.setitem(sys.modules, "SoapySDR", mod)
    _MockDevice.instances = []
    _MockDevice.FAIL_AFTER = None
    _MockDevice.MAX_READ = 100
    yield _MockDevice


def _expected_ramp(nbytes: int, start: int = 0) -> np.ndarray:
    return ((np.arange(nbytes) + start) % 256 - 128).astype(np.int8)


class TestSoapyDriver:
    def test_import_gate_without_module(self):
        from tpusdr_torch.io.shim import SoapySdrDriver

        assert "SoapySDR" not in sys.modules
        with pytest.raises(ImportError, match="SoapySDR"):
            SoapySdrDriver()

    def test_enumerate_and_open(self, soapy):
        from tpusdr_torch.io.shim import SoapySdrDriver

        drv = SoapySdrDriver(block_samples=256)
        devs = drv.enumerate()
        assert [d["serial"] for d in devs] == ["mock-0001", "mock-0002"]

        drv.open(serial="mock-0002")
        assert drv._dev.kwargs["serial"] == "mock-0002"
        drv.open(index=0)
        assert drv._dev.kwargs["serial"] == "mock-0001"
        drv.open()  # defaults to index 0 (HackrfSource.cpp:105-113 default)
        assert drv._dev.kwargs["serial"] == "mock-0001"
        with pytest.raises(ValueError, match="serial"):
            drv.open(serial="nope")

    def test_tune_and_gain_mapping(self, soapy):
        from tpusdr_torch.io.shim import SoapySdrDriver

        drv = SoapySdrDriver(block_samples=256)
        drv.open(index=0)
        drv.set_frequency(100.1e6)
        drv.set_sample_rate(10e6)
        drv.set_gain(lna_db=32, vga_db=8, amp=True)
        drv.set_gain(amp=False)
        assert drv._dev.calls == [
            ("setFrequency", SOAPY_SDR_RX, 0, 100.1e6),
            ("setSampleRate", SOAPY_SDR_RX, 0, 10e6),
            ("setGain", SOAPY_SDR_RX, 0, "LNA", 32.0),
            ("setGain", SOAPY_SDR_RX, 0, "VGA", 8.0),
            ("setGain", SOAPY_SDR_RX, 0, "AMP", 14.0),
            ("setGain", SOAPY_SDR_RX, 0, "AMP", 0.0),
        ]

    def test_read_block_short_read_loop(self, soapy):
        """256-sample block with 100-sample reads: the while-loop at
        io/shim.py readStream must stitch 3 partial reads, byte-exact."""
        from tpusdr_torch.io.shim import SoapySdrDriver

        drv = SoapySdrDriver(block_samples=256)
        drv.open(index=0)
        block = drv.read_block()
        dev = drv._dev
        assert len(block) == 2 * 256
        assert dev._reads == 3  # 100 + 100 + 56
        np.testing.assert_array_equal(
            np.frombuffer(block, np.int8), _expected_ramp(512)
        )
        # stream is set up + activated exactly once, reused on later reads
        block2 = drv.read_block()
        assert sum(c[0] == "setupStream" for c in dev.calls) == 1
        np.testing.assert_array_equal(
            np.frombuffer(block2, np.int8), _expected_ramp(512, start=512)
        )

    def test_read_error_raises(self, soapy):
        from tpusdr_torch.io.shim import SoapySdrDriver

        soapy.FAIL_AFTER = 1  # one good partial read, then a timeout code
        drv = SoapySdrDriver(block_samples=256)
        drv.open(index=0)
        with pytest.raises(RuntimeError, match="readStream error -1"):
            drv.read_block()


class TestSoapyShimIntegration:
    def test_pump_end_to_end(self, soapy):
        """Full deployment loop on the mock: control select/tune/start ->
        pump reads the Soapy driver -> data socket -> SocketIqSource blocks
        carry the device's exact CS8 bytes."""
        from tpusdr_torch.io.control import SdrControlClient
        from tpusdr_torch.io.shim import RfShim, SoapySdrDriver
        from tpusdr_torch.io.sources import SocketIqSource

        drv = SoapySdrDriver(block_samples=512)
        with RfShim(drv) as shim:
            with SdrControlClient("127.0.0.1", shim.control_port) as c:
                devs = c.ping()["devices"]
                assert devs[0]["serial"] == "mock-0001"
                c.select_device(serial="mock-0001")
                c.set_frequency(100e6)
                c.set_sample_rate(2e6)
                c.start()
                src = SocketIqSource(
                    "127.0.0.1", shim.data_port, 512, "int8", timeout_s=5.0
                )
                it = iter(src)
                words = next(it)  # int8 IQ arrives as packed int16 words
                src.close()
                c.stop()
        raw = words.view(np.int8)
        assert raw.shape == (1024,)
        # the stream is continuous: the first received block is some whole
        # block off the device's ramp (blocks before attach may be skipped)
        start = (int(raw[0]) + 128) % 256
        np.testing.assert_array_equal(raw, _expected_ramp(1024, start=start))

    def test_driver_fault_stops_stream(self, soapy):
        """A readStream error inside the pump = device unplug: streaming
        stops (shim.py driver-fault path), control plane stays up."""
        from tpusdr_torch.io.control import SdrControlClient
        from tpusdr_torch.io.shim import RfShim, SoapySdrDriver

        soapy.FAIL_AFTER = 2
        drv = SoapySdrDriver(block_samples=512)
        with RfShim(drv) as shim:
            with SdrControlClient("127.0.0.1", shim.control_port) as c:
                c.select_device(index=0)
                c.start()
                deadline = time.time() + 5.0
                while shim.started and time.time() < deadline:
                    time.sleep(0.01)
                assert not shim.started, "pump kept running past driver fault"
                # control plane still answers
                assert c.ping()["devices"]
