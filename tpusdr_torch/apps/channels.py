"""Multi-channel receiver CLI: channelize a wideband capture and
FM-demodulate every channel at once (port of tpusdr/apps/channels.py).

One polyphase channelizer and one batched demod chain
(``models.multichannel.fm_channel_bank``) run through the StreamRunner;
each channel named in ``--write`` gets a WAV file, ``ch<k>.wav``.  An
integer capture (``--format int8`` / ``int16``) goes through
``IqToComplex`` first.

Example:
  python -m tpusdr_torch.apps.channels --input synth --rf-rate 5.12e6 \\
      --channels 16 --write 2,13 --duration 2 --out-dir /tmp/chans

``--device`` defaults to ``cuda``; without a CUDA device the app stops
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from tpusdr_torch.graph.blocks import IqToComplex
from tpusdr_torch.graph.chain import Chain
from tpusdr_torch.graph.runner import StreamRunner
from tpusdr_torch.io.sinks import WavSink
from tpusdr_torch.io.sources import FileIqSource, SyntheticIqSource
from tpusdr_torch.models import multichannel
from tpusdr_torch.utils.logging import get_logger

log = get_logger("apps.channels")


def two_stations(rf_rate: float, num_channels: int, deviation: float):
    """The synthetic source's block maker: FM stations on channels 2 and
    M-3 carrying 700 Hz and 1,200 Hz, each at amplitude 0.5.  As in the JAX
    app, the modulation's running sum restarts every block."""
    k1, k2 = 2 % num_channels, (num_channels - 3) % num_channels

    def make(t: np.ndarray) -> np.ndarray:
        def fm(fk, fa):
            audio = np.sin(2 * np.pi * fa * t)
            return np.exp(1j * (2 * np.pi * fk * t + 2 * np.pi * deviation * np.cumsum(audio) / rf_rate))

        z = 0.5 * fm(k1 * rf_rate / num_channels, 700.0) + 0.5 * fm(k2 * rf_rate / num_channels, 1200.0)
        return z.astype(np.complex64)

    return make


class ChannelWavSinks:
    """Writes row k of each (channels, n) audio block to channel k's WAV."""

    def __init__(self, out_dir: str, channels: list[int], audio_rate: float):
        self.sinks = {c: WavSink(os.path.join(out_dir, f"ch{c:03d}.wav"), audio_rate) for c in channels}

    def write(self, audio: np.ndarray) -> None:
        for c, sink in self.sinks.items():
            sink.write(audio[c])

    def close(self) -> None:
        for sink in self.sinks.values():
            sink.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="tpusdr_torch multi-channel FM receiver")
    ap.add_argument("--input", default="synth")
    ap.add_argument("--format", default="cf32", choices=["int8", "int16", "cf32"])
    ap.add_argument("--rf-rate", type=float, default=5.12e6)
    ap.add_argument("--channels", type=int, default=16)
    ap.add_argument("--audio-rate", type=float, default=16000.0)
    ap.add_argument("--write", default="", help="comma-separated channel indices")
    ap.add_argument("--out-dir", default="channels_out")
    ap.add_argument("--duration", type=float, default=2.0)
    ap.add_argument("--tick", type=int, default=1 << 20)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run the chain on ('cuda', 'cuda:1', 'cpu')")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu to run on the CPU")
    write = [int(c) for c in args.write.split(",") if c != ""]
    bad = [c for c in write if not 0 <= c < args.channels]
    if bad:
        ap.error(f"--write names channels {bad} outside 0..{args.channels - 1}")

    chain, info = multichannel.fm_channel_bank(args.rf_rate, args.channels, args.audio_rate)
    if args.format != "cf32":
        chain = Chain([("iq", IqToComplex(args.format)), *chain.blocks])
    chain.to(device)
    tick = max(1, args.tick // chain.granule) * chain.granule
    n_blocks = max(1, int(args.duration * args.rf_rate / tick))

    if args.input == "synth":
        dev = min(75e3, info["channel_rate"] / 4)
        make = two_stations(args.rf_rate, args.channels, dev)
        src = SyntheticIqSource(tick, args.rf_rate, make, args.format, n_blocks)
    else:
        src = FileIqSource(args.input, tick, args.format, max_blocks=n_blocks)

    os.makedirs(args.out_dir, exist_ok=True)
    sink = ChannelWavSinks(args.out_dir, write, info["audio_rate"])
    try:
        _, stats = StreamRunner(chain, device=device).run(iter(src), sink, max_blocks=n_blocks)
    finally:
        sink.close()
    print(
        f"{args.channels} channels: {stats.samples_in / 1e6:.2f} M RF samples in "
        f"{stats.wall_seconds:.2f}s ({stats.msps_in:.2f} Msps); wrote {sorted(sink.sinks)} "
        f"to {args.out_dir}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
