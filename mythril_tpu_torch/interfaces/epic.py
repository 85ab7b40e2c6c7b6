"""The ``--epic`` report filter.

Reference parity: mythril/interfaces/epic.py (a vendored lolcat clone).
This build keeps the tradition without the vendored dependency: a small
ANSI-256 rainbow over the report text, phase-shifted per line.  Pure
cosmetics, honored only for text/markdown output; redirected (non-TTY)
streams get the plain text so piped reports stay readable.
"""

from __future__ import annotations

import math
import sys

# a smooth 256-color rainbow ramp (same hue circle lolcat samples)
def _rainbow_color(i: float) -> int:
    red = math.sin(0.1 * i) * 127 + 128
    green = math.sin(0.1 * i + 2 * math.pi / 3) * 127 + 128
    blue = math.sin(0.1 * i + 4 * math.pi / 3) * 127 + 128
    # map rgb to the xterm 6x6x6 cube
    return (
        16
        + 36 * int(red / 256 * 6)
        + 6 * int(green / 256 * 6)
        + int(blue / 256 * 6)
    )


def rainbowify(text: str, freq_shift: float = 0.0) -> str:
    out_lines = []
    for li, line in enumerate(text.splitlines()):
        chunks = []
        for ci, ch in enumerate(line):
            color = _rainbow_color(freq_shift + li * 3 + ci * 0.8)
            chunks.append(f"\x1b[38;5;{color}m{ch}")
        out_lines.append("".join(chunks))
    return "\n".join(out_lines) + "\x1b[0m"


def print_epic(text: str, stream=None) -> None:
    stream = stream or sys.stdout
    try:
        is_tty = stream.isatty()
    except Exception:
        is_tty = False
    stream.write((rainbowify(text) if is_tty else text) + "\n")
