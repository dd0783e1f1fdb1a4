"""
ShaderDynamics — the second-order smoother as a scene module.

Port of shaderflow_tpu/dynamics.py: wraps DynamicNumber (ops/dynamics.py)
so it steps once per frame on scene.dt (or the real rdt when real=True),
infers its GLSL uniform type from the value shape, and exports `Name` /
`NameIntegral` / `NameDerivative` uniforms. Host numpy state.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

from shaderflow_tpu_torch.variable import ShaderVariable
from shaderflow_tpu_torch.module import ShaderModule
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
        DynamicNumber.__init__(
            self, value=value, target=target, frequency=frequency, zeta=zeta,
            response=response, precision=precision, integrate=integrate, dtype=dtype)
        ShaderModule.__init__(self, scene=scene, name=name, **kwargs)

    def setup(self) -> None:
        self.reset(instant=self.scene.freewheel)

    def update(self) -> None:
        # abs(dt): the system is unstable backwards in time
        self.next(dt=abs(self.scene.rdt if self.real else self.scene.dt))

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
