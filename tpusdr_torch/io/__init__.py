"""tpusdr_torch.io — host-side stream ingest and egress (port of
tpusdr/io/__init__.py).

Sources (a capture file, a TCP IQ socket, a synthetic signal, a callable),
sinks (WAV, compressed audio through ffmpeg, raw, collecting, counting), the
RF-host shim and its drivers (``shim``) with their control plane
(``control``), and the native read-ahead ring (``native``).
"""

from tpusdr_torch.io.sources import (  # noqa: F401
    CallbackSource,
    FileIqSource,
    SocketIqSource,
    SyntheticIqSource,
)
from tpusdr_torch.io.sinks import (  # noqa: F401
    CollectSink,
    NullSink,
    RawFileSink,
    WavSink,
)
from tpusdr_torch.io.shim import (  # noqa: F401
    FakeSdrDriver,
    RfShim,
    SdrDriver,
    Station,
)
