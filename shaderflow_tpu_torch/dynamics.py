"""
ShaderDynamics — the second-order smoother as a scene module.

Port of shaderflow_tpu/dynamics.py: wraps DynamicNumber (ops/dynamics.py)
so it steps once per frame on scene.dt (or the real rdt when real=True),
infers its GLSL uniform type from the value shape, and exports `Name` /
`NameIntegral` / `NameDerivative` uniforms. Host numpy state. Its HUD
panel edits f, zeta and response and plots the value's history.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Optional

import numpy as np

from shaderflow_tpu_torch.variable import ShaderVariable
from shaderflow_tpu_torch.module import ShaderModule, UIField, UIPlot
from shaderflow_tpu_torch.ops.dynamics import DynamicNumber


class ShaderDynamics(ShaderModule, DynamicNumber):

    def __init__(
        self,
        scene=None,
        name: str = "iShaderDynamics",
        *,
        real: bool = False,
        primary: bool = True,
        differentiate: bool = False,
        value=0.0,
        target=None,
        frequency: float = 1.0,
        zeta: float = 1.0,
        response: float = 0.0,
        precision: float = 1e-6,
        integrate: bool = False,
        dtype=np.float64,
        **kwargs,
    ):
        self.real = real
        self.primary = primary
        self.differentiate = differentiate
        self._ui_history: Optional[deque] = None
        DynamicNumber.__init__(
            self, value=value, target=target, frequency=frequency, zeta=zeta,
            response=response, precision=precision, integrate=integrate, dtype=dtype)
        ShaderModule.__init__(self, scene=scene, name=name, **kwargs)

    def setup(self) -> None:
        self.reset(instant=self.scene.freewheel)

    def update(self) -> None:
        # abs(dt): the system is unstable backwards in time
        self.next(dt=abs(self.scene.rdt if self.real else self.scene.dt))
        # The HUD plot's history: host values only (a device value here
        # would make the append a read back)
        if isinstance(self.value, (int, float, np.generic, np.ndarray)):
            if self._ui_history is None:
                self._ui_history = deque(maxlen=240)
            self._ui_history.append(float(np.asarray(self.value).reshape(-1)[0]))

    @property
    def type(self) -> Optional[str]:
        shape = np.shape(self.value)
        if not shape or shape[0] == 1:
            return "float"
        if shape[0] in (2, 3, 4):
            return f"vec{shape[0]}"
        return None

    def pipeline(self) -> Iterable[ShaderVariable]:
        kind = self.type
        if not kind:
            return
        if self.primary:
            yield self.uniform(kind, self.name, self.value)
        if self.integrate:
            yield self.uniform(kind, f"{self.name}Integral", self.integral)
        if self.differentiate:
            yield self.uniform(kind, f"{self.name}Derivative", self.derivative)

    def ui(self):
        value = np.asarray(self.value).reshape(-1)
        yield f"f={self.frequency:.2f}  z={self.zeta:.2f}  r={self.response:.2f}"
        yield "value " + " ".join(f"{v:+.3f}" for v in value[:4])

    def ui_plots(self):
        return [UIPlot("value", list(self._ui_history))] if self._ui_history else []

    def ui_fields(self):
        def setter(attr):
            def set(value):
                setattr(self, attr, value)
            return set

        # f = 0 would freeze the system (k1, k2 blow up): kept positive;
        # zeta and response may be anything (zeta < 0 self-oscillates,
        # response < 0 anticipates)
        return [
            UIField("f", lambda: self.frequency, setter("frequency"), step=0.1, minimum=0.01),
            UIField("zeta", lambda: self.zeta, setter("zeta"), step=0.1),
            UIField("response", lambda: self.response, setter("response"), step=0.1),
        ]
