"""rf_shim — run the RF-host shim next to a radio (or a fake one); port of
tpusdr/apps/rf_shim.py:27-78.

The deployment story the reference bakes into one process (HackrfSource's
USB callback feeding the pipeline in-process, HackrfSource.cpp:175-201)
splits across hosts here: this program runs ON THE RF HOST, owns the
radio, and serves two sockets — control (JSON commands, io/control.py) and
data (interleaved int8 IQ).  The receiver on the card's host connects a
SocketIqSource to the data port and a SdrControlClient to the control
port (see tests/test_torch_shim.py for the full loop).

Examples:

  # synthetic radio for development: one FM station at 100.1 MHz
  python -m tpusdr_torch.apps.rf_shim --driver fake --stations 100.1e6:fm:1000 \
      --control-port 7301 --data-port 7302 --realtime

  # real hardware via SoapySDR (on a host with the SDR stack installed)
  python -m tpusdr_torch.apps.rf_shim --driver soapy --soapy-args driver=hackrf
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--driver", choices=("fake", "soapy"), default="fake")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--control-port", type=int, default=7301)
    ap.add_argument("--data-port", type=int, default=7302)
    ap.add_argument(
        "--stations",
        nargs="*",
        default=["100.1e6:fm:1000"],
        help="fake driver emitters, FREQ[:KIND[:AUDIO_HZ]] (kind cw|fm)",
    )
    ap.add_argument("--block-samples", type=int, default=16384)
    ap.add_argument(
        "--realtime",
        action="store_true",
        help="fake driver paces blocks at the configured sample rate",
    )
    ap.add_argument("--noise", type=float, default=0.0)
    ap.add_argument("--soapy-args", default="", help="SoapySDR device args")
    args = ap.parse_args(argv)

    from tpusdr_torch.io import shim as shim_mod

    if args.driver == "fake":
        driver = shim_mod.FakeSdrDriver(
            stations=[shim_mod.Station.parse(s) for s in args.stations],
            block_samples=args.block_samples,
            realtime=args.realtime,
            noise=args.noise,
        )
    else:
        driver = shim_mod.SoapySdrDriver(
            driver_args=args.soapy_args, block_samples=args.block_samples
        )

    with shim_mod.RfShim(
        driver,
        host=args.host,
        control_port=args.control_port,
        data_port=args.data_port,
    ) as shim:
        print(
            f"rf shim: control {args.host}:{shim.control_port}, "
            f"data {args.host}:{shim.data_port}",
            flush=True,
        )
        try:
            while True:
                time.sleep(1.0)
        except KeyboardInterrupt:
            pass


if __name__ == "__main__":
    main()
