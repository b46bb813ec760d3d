"""Embedding API: a runnable pipeline from a serialized spec (port of
tpusdr/session.py, the counterpart of the reference's
``createSession(uint8_t*, size_t)``).  The payload is the JSON app spec of
``graph/app.py``."""

from __future__ import annotations

from tpusdr_torch.graph.app import App, compile_app


def create_session(data: bytes | str, tick: int = 1 << 20, device=None) -> App:
    """Parse a JSON pipeline spec and return a runnable App on ``device``
    (default ``cuda``: without a card this raises; pass ``device="cpu"``
    to run on the CPU)."""
    if isinstance(data, (bytes, bytearray)):
        data = data.decode("utf-8")
    return compile_app(data, tick=tick, device=device)
