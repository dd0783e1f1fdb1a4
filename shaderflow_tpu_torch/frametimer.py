"""
Frame timing statistics — port of shaderflow_tpu/frametimer.py: a rolling
window of real frame deltas sized history-seconds x fps, with average /
min / max frametime and framerate plus percentile cuts, and its HUD panel
(the rates and a sparkline of the frametimes).
"""

from __future__ import annotations

from collections import deque

import numpy as np

from shaderflow_tpu_torch.module import ShaderModule, UIPlot


class ShaderFrametimer(ShaderModule):

    history: float = 2.0

    def __init__(self, scene=None, **kwargs):
        self.frametimes: deque[float] = deque()
        super().__init__(scene=scene, **kwargs)

    @property
    def length(self) -> int:
        return max(int(self.history * self.scene.fps), 10)

    def update(self) -> None:
        if self.scene.rdt == 0:
            return
        self.frametimes.append(self.scene.rdt)
        while len(self.frametimes) > self.length:
            self.frametimes.popleft()

    def percent(self, percent: float = 100.0) -> np.ndarray:
        cut = int(len(self.frametimes) * (percent / 100))
        return np.sort(np.asarray(self.frametimes))[-max(cut, 1):]

    @staticmethod
    def _finite(value: float) -> float:
        return value if value < 1e8 else 0.0

    def frametime_average(self, percent: float = 100.0) -> float:
        window = self.percent(percent)
        return float(window.sum() / (len(window) + 1e-9))

    @property
    def frametime_maximum(self) -> float:
        return max(self.frametimes, default=0.0)

    @property
    def frametime_minimum(self) -> float:
        return min(self.frametimes, default=0.0)

    def framerate_average(self, percent: float = 100.0) -> float:
        return self._finite(1.0 / (self.frametime_average(percent) + 1e-9))

    @property
    def framerate_maximum(self) -> float:
        return self._finite(1.0 / (self.frametime_minimum + 1e-9))

    @property
    def framerate_minimum(self) -> float:
        return self._finite(1.0 / (self.frametime_maximum + 1e-9))

    def ui(self):
        yield (f"fps avg {self.framerate_average():6.1f}  "
               f"min {self.framerate_minimum:6.1f}  max {self.framerate_maximum:6.1f}")
        yield (f"dt avg {1000 * self.frametime_average():6.2f} ms  "
               f"max {1000 * self.frametime_maximum:6.2f} ms")

    def ui_plots(self):
        return [UIPlot("frametime ms", [1000.0 * dt for dt in self.frametimes], lo=0.0)]
