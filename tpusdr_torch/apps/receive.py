"""RF -> audio receiver CLI (port of tpusdr/apps/receive.py:36-219).

Reads IQ from a file, a TCP socket or a synthetic source, runs a WBFM,
NBFM or AM chain on the chosen device through the StreamRunner, writes
WAV (or, through ffmpeg, compressed) audio and prints throughput counters;
optionally writes the graph as dot (``--dot``), dumps the pre-demod IF
beside the audio in one pass (``--dump-if``), saves or restores the
stream state (``--checkpoint``, ``--resume``), and reads a capture file
through the host library's read-ahead thread (``--native``,
``io/native.py``).

Examples:
  python -m tpusdr_torch.apps.receive --mod wbfm --input synth --rf-rate 2e6 \\
      --duration 2 --audio out.wav
  python -m tpusdr_torch.apps.receive --device cpu --mod am --format int8 \\
      --input synth --rf-rate 2e6 --offset 100e3 --audio am.wav
  python -m tpusdr_torch.apps.receive --mod wbfm --format int8 --input cap.iq \\
      --rf-rate 20e6 --offset 2.5e6 --tick 1280000 --native --audio fm.wav

``--device`` defaults to ``cuda``; without a CUDA device the CLI stops
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from tpusdr_torch.graph.checkpoint import load_state, save_state
from tpusdr_torch.graph.dot import to_dot
from tpusdr_torch.graph.graph import tapped
from tpusdr_torch.graph.runner import StreamRunner
from tpusdr_torch.io.native import NativeFileStream
from tpusdr_torch.io.sinks import AacFileSink, NullSink, RawFileSink, WavSink
from tpusdr_torch.io.sources import FileIqSource, SocketIqSource, SyntheticIqSource
from tpusdr_torch.models import receiver
from tpusdr_torch.utils.logging import get_logger, set_log_level

log = get_logger("apps.receive")


def _parse_float(s: str) -> float:
    return float(eval(s, {"__builtins__": {}}, {}))  # allows "145.45e6-145e6"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="tpusdr_torch RF->audio receiver")
    ap.add_argument("--mod", choices=["wbfm", "nbfm", "am"], default="wbfm")
    ap.add_argument("--input", default="synth",
                    help="'synth', an IQ file path, or host:port for a TCP IQ stream")
    ap.add_argument("--format", default="cf32", choices=["int8", "int16", "cf32"])
    ap.add_argument("--rf-rate", type=_parse_float, default=2e6)
    ap.add_argument("--offset", type=_parse_float, default=0.0,
                    help="channel center minus capture center, Hz")
    ap.add_argument("--audio-rate", type=_parse_float, default=48000.0)
    ap.add_argument("--audio", default=None,
                    help="output audio path (.wav native; .aac/.m4a/.ts via ffmpeg)")
    ap.add_argument("--duration", type=float, default=2.0,
                    help="seconds of RF to process (file/synth)")
    ap.add_argument("--tick", type=int, default=1 << 20,
                    help="streaming block size target, samples")
    ap.add_argument("--no-deemphasis", action="store_true")
    ap.add_argument("--channel-width", type=_parse_float, default=None,
                    help="override channel width, Hz")
    ap.add_argument("--deviation", type=_parse_float, default=None,
                    help="override FM deviation, Hz")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run the chain on ('cuda', 'cuda:1', 'cpu')")
    ap.add_argument("--dot", default=None, help="write graph dot file")
    ap.add_argument("--dump-if", default=None,
                    help="also dump the pre-demod IF stream (complex64 raw) to this path: "
                    "audio and raw IF in one pass")
    ap.add_argument("--checkpoint", default=None,
                    help="save stream state here after the run (resume with --resume)")
    ap.add_argument("--resume", default=None,
                    help="restore stream state from a checkpoint before the run")
    ap.add_argument("--native", action="store_true",
                    help="read a capture file ahead on a native thread (io/native.py); "
                    "no effect on synth or socket input")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu to run on the CPU")
    if args.verbose:
        set_log_level("debug")

    fs = args.rf_rate
    if args.mod == "am":
        chain, spec = receiver.am_receiver(fs, args.offset, args.audio_rate, input_format=args.format)
    else:
        chain, spec = receiver.fm_receiver(
            fs,
            args.offset,
            receiver.WBFM if args.mod == "wbfm" else receiver.NBFM,
            args.audio_rate,
            channel_width=args.channel_width,
            deviation=args.deviation,
            deemphasis_tau=None if args.no_deemphasis else receiver.TAU_US,
            input_format=args.format,
            # the IF tap needs the unfused shift -> FIR -> demod stages
            use_fused=False if args.dump_if else "auto",
        )
    chain.to(device)

    tick = max(1, args.tick // chain.granule) * chain.granule
    n_blocks = max(1, int(args.duration * fs / tick))

    if args.dot:
        with open(args.dot, "w") as f:
            f.write(to_dot(chain, f"{args.mod}_receiver"))
        log.info("wrote %s", args.dot)

    if args.input == "synth":
        if args.mod == "am":
            src = SyntheticIqSource.am(tick, fs, args.offset, args.format, n_blocks)
        else:
            dev = args.deviation or (
                receiver.WBFM_DEVIATION if args.mod == "wbfm" else receiver.NBFM_DEVIATION
            )
            src = SyntheticIqSource.fm(tick, fs, 1000.0, dev, args.offset, args.format, n_blocks)
    elif ":" in args.input and not args.input.endswith((".iq", ".bin", ".dat", ".raw")):
        host, port = args.input.rsplit(":", 1)
        src = SocketIqSource(host, int(port), tick, args.format)
        if args.duration <= 0:
            n_blocks = None  # stream until the socket closes
    elif args.native:
        # the same words as FileIqSource's; they convert on the card
        try:
            src = NativeFileStream(args.input, tick, args.format)
        except (RuntimeError, OSError) as e:
            ap.error(f"--native: {e}")
    else:
        src = FileIqSource(args.input, tick, args.format, max_blocks=n_blocks)

    # sink by extension: .wav native, anything else through ffmpeg
    if not args.audio:
        sink = NullSink()
    elif args.audio.endswith(".wav"):
        sink = WavSink(args.audio, spec.audio_rate)
    else:
        sink = AacFileSink(args.audio, spec.audio_rate)

    block = chain
    if args.dump_if:
        names = [n for n, _ in chain.blocks]
        if_tap = names[names.index("demod") - 1]
        block = tapped(chain, [if_tap])
        sink = [sink, RawFileSink(args.dump_if, np.complex64)]
        log.info("dumping IF (tap %r) to %s", if_tap, args.dump_if)

    runner = StreamRunner(block, device=device)
    state = None
    if args.resume:
        state = load_state(args.resume, runner.init_state())
        log.info("resumed stream state from %s", args.resume)
    try:
        state, stats = runner.run(iter(src), sink, state=state, max_blocks=n_blocks)
        if args.checkpoint:
            save_state(args.checkpoint, state)
            log.info("stream state checkpointed to %s", args.checkpoint)
    finally:
        for s in sink if isinstance(sink, list) else [sink]:
            s.close()
        if isinstance(src, NativeFileStream):
            src.close()

    print(
        f"{args.mod}: {stats.samples_in / 1e6:.2f} M RF samples -> "
        f"{stats.samples_out / 1e3:.1f} k audio samples in {stats.wall_seconds:.2f}s "
        f"({stats.msps_in:.2f} Msps) on {device}"
    )
    if args.audio:
        print(f"audio written to {args.audio} @ {spec.audio_rate:.0f} Hz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
