"""Small integer/shape helpers used by the rate planner and kernels."""

from __future__ import annotations

import math


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def lcm(*xs: int) -> int:
    out = 1
    for x in xs:
        out = math.lcm(out, x)
    return out
