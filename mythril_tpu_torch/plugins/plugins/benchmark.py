"""Benchmark plugin: coverage-over-time + executed-instruction counts.

Reference parity: mythril/laser/plugin/plugins/benchmark.py:19-94.  The
reference renders a matplotlib png at shutdown; this environment is headless
and matplotlib-free, so the series is persisted as JSON plus a
dependency-free SVG line chart (single series: executed instructions over
wall time).
"""

from __future__ import annotations

import json
import logging
import time
from typing import List, Tuple
from xml.sax.saxutils import escape

from mythril_tpu_torch.plugins.interface import LaserPlugin, PluginBuilder

log = logging.getLogger(__name__)

# chart tokens (light surface), single categorical series
_SURFACE = "#fcfcfb"
_INK = "#0b0b0b"
_INK_MUTED = "#52514e"
_SERIES = "#2a78d6"
_GRID = "#e8e7e4"


def render_series_svg(
    points: List[Tuple[float, int]],
    title: str,
    y_label: str = "executed instructions",
    width: int = 640,
    height: int = 360,
) -> str:
    """A minimal single-series line chart as standalone SVG markup.

    One series needs no legend (the title names it); the line is 2px, the
    grid recessive, text in ink tokens rather than the series color.
    """
    ml, mr, mt, mb = 56, 16, 40, 36  # margins: left/right/top/bottom
    pw, ph = width - ml - mr, height - mt - mb
    title, y_label = escape(title), escape(y_label)
    xs = [p[0] for p in points] or [0.0]
    ys = [p[1] for p in points] or [0]
    x_max = max(xs) or 1.0
    y_max = max(ys) or 1

    def px(x: float) -> float:
        return ml + (x / x_max) * pw

    def py(y: float) -> float:
        return mt + ph - (y / y_max) * ph

    # ~4 horizontal gridlines at round y values
    step = max(1, y_max // 4)
    grid, labels = [], []
    y = step
    while y <= y_max:
        gy = py(y)
        grid.append(
            f'<line x1="{ml}" y1="{gy:.1f}" x2="{ml + pw}" y2="{gy:.1f}" '
            f'stroke="{_GRID}" stroke-width="1"/>'
        )
        labels.append(
            f'<text x="{ml - 6}" y="{gy + 4:.1f}" text-anchor="end" '
            f'font-size="11" fill="{_INK_MUTED}">{y}</text>'
        )
        y += step
    path = " ".join(
        f"{'M' if i == 0 else 'L'}{px(x):.1f},{py(v):.1f}"
        for i, (x, v) in enumerate(points or [(0.0, 0)])
    )
    last_x, last_y = points[-1] if points else (0.0, 0)
    font = "font-family='system-ui, sans-serif'"
    return (
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
        f'height="{height}" viewBox="0 0 {width} {height}">'
        f'<rect width="{width}" height="{height}" fill="{_SURFACE}"/>'
        f'<text x="{ml}" y="22" font-size="14" {font} fill="{_INK}">{title}</text>'
        + "".join(grid)
        + "".join(labels)
        + f'<line x1="{ml}" y1="{mt + ph}" x2="{ml + pw}" y2="{mt + ph}" '
        f'stroke="{_INK_MUTED}" stroke-width="1"/>'
        f'<path d="{path}" fill="none" stroke="{_SERIES}" stroke-width="2" '
        f'stroke-linejoin="round"><title>{y_label}</title></path>'
        f'<circle cx="{px(last_x):.1f}" cy="{py(last_y):.1f}" r="3" '
        f'fill="{_SERIES}"/>'
        f'<text x="{ml}" y="{height - 8}" font-size="11" {font} '
        f'fill="{_INK_MUTED}">0</text>'
        f'<text x="{ml + pw}" y="{height - 8}" text-anchor="end" font-size="11" '
        f'{font} fill="{_INK_MUTED}">{x_max:.1f}s</text>'
        "</svg>"
    )


class BenchmarkPlugin(LaserPlugin):
    def __init__(self, name: str = "benchmark"):
        self.nr_of_executed_insns = 0
        self.begin: float = 0.0
        self.end: float = 0.0
        self.points: List[Tuple[float, int]] = []
        self.name = name
        self._device_insns_at_start = 0

    def initialize(self, symbolic_vm) -> None:
        self.begin = time.perf_counter()
        # the series tracks host-stepped instructions (execute_state hooks);
        # device-frontier segments bypass those hooks, so their instruction
        # total is reported separately from FrontierStatistics
        from mythril_tpu_torch.frontier.stats import FrontierStatistics

        self._device_insns_at_start = FrontierStatistics().device_instructions

        def execute_state_hook(_):
            self.nr_of_executed_insns += 1
            self.points.append((time.perf_counter() - self.begin, self.nr_of_executed_insns))

        def stop_hook():
            self.end = time.perf_counter()
            duration = self.end - self.begin
            rate = self.nr_of_executed_insns / duration if duration > 0 else 0.0
            log.info(
                "Benchmark: %d instructions in %.2fs (%.0f/s)",
                self.nr_of_executed_insns,
                duration,
                rate,
            )

        symbolic_vm.register_laser_hooks("execute_state", execute_state_hook)
        symbolic_vm.register_laser_hooks("stop_sym_exec", stop_hook)

    def write_to_file(self, path: str) -> None:
        """Persist the series as JSON at ``path`` and an SVG chart at
        ``path + ".svg"`` — the role of the reference's matplotlib png.

        Long runs are downsampled to <=10000 points spanning the WHOLE run
        (stride recorded in the JSON), never truncated."""
        from mythril_tpu_torch.frontier.stats import FrontierStatistics

        stride = max(1, -(-len(self.points) // 10000))  # ceil div
        series = self.points[::stride]
        if series and self.points[-1] != series[-1]:
            series.append(self.points[-1])
        device_insns = (
            FrontierStatistics().device_instructions - self._device_insns_at_start
        )
        with open(path, "w") as f:
            json.dump(
                {
                    "executed_instructions": self.nr_of_executed_insns,
                    # instructions executed by device-frontier segments (not
                    # in the host hook series; 0 unless --frontier)
                    "device_instructions": device_insns,
                    "duration": self.end - self.begin,
                    "series_stride": stride,
                    "series": series,
                },
                f,
            )
        with open(path + ".svg", "w") as f:
            f.write(
                render_series_svg(
                    series, title=f"{self.name}: instructions over time"
                )
            )


class BenchmarkPluginBuilder(PluginBuilder):
    name = "benchmark"

    def __call__(self, *args, **kwargs) -> LaserPlugin:
        return BenchmarkPlugin()
