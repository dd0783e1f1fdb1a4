"""
Second-order ODE smoothing — the f / zeta / r system, host form.

Same dynamical system as shaderflow_tpu/ops/dynamics.py (the reference
dynamics module, t3ssel8r's parameterization integrated with semi-implicit
Euler, k2 stability clamp, pole matching for fast systems). Two forms:

  * step() and DynamicNumber: one step on numpy arrays or tensors — host
    modules (ShaderDynamics, camera parameters) step it per frame.
  * scan(): a whole (F, ...) target trajectory smoothed at a fixed timestep
    (the reference's lax.scan): a loop over frames on tensors, run once per
    export by the audio precomputes.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class Coefficients(NamedTuple):
    """Integration coefficients for a fixed (frequency, zeta, response, dt)."""
    k1: float
    k2: float
    k3: float

    @staticmethod
    def compute(frequency: float, zeta: float, response: float, dt: float) -> "Coefficients":
        radians = math.tau * frequency
        k1 = zeta / (math.pi * frequency)
        k2 = 1.0 / (radians * radians)
        k3 = (response * zeta) / (math.tau * frequency)

        if radians * dt < zeta:
            # Clamp k2 to stable values without jitter
            k2 = max(k1 * dt, k2, 0.5 * (k1 + dt) * dt)
        else:
            # Pole matching when the system is very fast
            damping = radians * abs(zeta * zeta - 1.0) ** 0.5
            t1 = math.exp(-zeta * radians * dt)
            a1 = 2.0 * t1 * (math.cos(damping * dt) if zeta <= 1 else math.cosh(damping * dt))
            t2 = dt / (1.0 + t1 * t1 - a1)
            k1 = t2 * (1.0 - t1 * t1)
            k2 = t2 * dt
        return Coefficients(k1, k2, k3)


def step(value, derivative, previous, target, dt: float, coeffs: Coefficients):
    """One semi-implicit Euler step -> (value, derivative, previous), on
    numpy arrays or tensors alike."""
    velocity = (target - previous) / dt
    value = value + derivative * dt
    acceleration = (target + coeffs.k3 * velocity - value - coeffs.k1 * derivative) / coeffs.k2
    derivative = derivative + acceleration * dt
    return value, derivative, target


def scan(targets: torch.Tensor, initial_value, dt: float, frequency: float = 1.0,
         zeta: float = 1.0, response: float = 0.0, integrate: bool = False):
    """Smooth a whole (F, ...) float32 target trajectory at a fixed timestep
    -> (F, ...) smoothed values, and with integrate=True also the running
    integral. One step per frame, in order, on the targets' device."""
    coeffs = Coefficients.compute(frequency, zeta, response, dt)
    targets = torch.as_tensor(targets, dtype=torch.float32)
    value = torch.as_tensor(initial_value, dtype=torch.float32,
                            device=targets.device).expand(targets.shape[1:])
    previous = value
    derivative = torch.zeros_like(value)
    integral = torch.zeros_like(value)
    values = torch.empty_like(targets)
    integrals = torch.empty_like(targets) if integrate else None
    for index in range(targets.shape[0]):
        value, derivative, previous = step(value, derivative, previous,
                                           targets[index], dt, coeffs)
        values[index] = value
        if integrate:
            integral = integral + value * dt
            integrals[index] = integral
    if integrate:
        return values, integrals
    return values


class DynamicNumber:
    """Host-side progressive second-order system (numpy state):
    .value/.target/.next(), frequency/zeta/response parameters, integral
    accumulation, precision early-out, vectorized over ndarrays (including
    quaternion 4-vectors)."""

    def __init__(self, value=0.0, target=None, frequency: float = 1.0, zeta: float = 1.0,
                 response: float = 0.0, precision: float = 1e-6, integrate: bool = False,
                 dtype=np.float64):
        self.frequency = float(frequency)
        self.zeta = float(zeta)
        self.response = float(response)
        self.precision = float(precision)
        self.integrate = bool(integrate)
        self.dtype = np.dtype(dtype)
        self.set(value if target is None else target)

    # -- state management ---------------------------------------------------

    def _asarray(self, value) -> np.ndarray:
        return np.array(value, dtype=self.dtype)

    @property
    def value(self) -> np.ndarray:
        return self._value

    @value.setter
    def value(self, new) -> None:
        self._value = self._asarray(new)

    @property
    def target(self) -> np.ndarray:
        return self._target

    @target.setter
    def target(self, new) -> None:
        """Assignment coerces to ndarray; shape growth re-seeds the state."""
        new = self._asarray(new)
        if hasattr(self, "_target") and new.shape != self._value.shape:
            self.set(new)
            return
        self._target = new

    def set(self, value, *, instant: bool = True) -> None:
        value = self._asarray(value)
        if instant or not hasattr(self, "value"):
            self.value = value.copy()
            self.previous = value.copy()
        self.target = value.copy()
        self.initial = value.copy()
        self.integral = np.zeros_like(value)
        self.derivative = np.zeros_like(value)
        self.acceleration = np.zeros_like(value)

    def reset(self, instant: bool = False) -> None:
        self.set(self.initial, instant=instant)

    # -- integration --------------------------------------------------------

    def next(self, target=None, dt: float = 1.0) -> np.ndarray:
        if not dt:
            return self.value

        if target is not None:
            target = self._asarray(target)
            if target.shape != self.value.shape:
                self.set(target)
            self.target = target

        # Skip work when already settled (precision early-out)
        if np.abs(self.target - self.value).max() < self.precision:
            if self.integrate:
                self.integral += self.value * dt
            return self.value

        coeffs = Coefficients.compute(self.frequency, self.zeta, self.response, dt)
        velocity = (self.target - self.previous) / dt
        self.previous = self.target.copy()
        self.value = self.value + self.derivative * dt
        self.acceleration = (self.target + coeffs.k3 * velocity
                             - self.value - coeffs.k1 * self.derivative) / coeffs.k2
        self.derivative = self.derivative + self.acceleration * dt
        if self.integrate:
            self.integral += self.value * dt
        return self.value

    # -- number-like sugar --------------------------------------------------

    def __float__(self) -> float: return float(self.value)
    def __int__(self) -> int: return int(self.value)
    def __mul__(self, other): return self.value * other
    __rmul__ = __mul__
    def __add__(self, other): return self.value + other
    __radd__ = __add__
    def __sub__(self, other): return self.value - other
    def __rsub__(self, other): return other - self.value
    def __truediv__(self, other): return self.value / other
    def __rtruediv__(self, other): return other / self.value
    def __pow__(self, other): return self.value ** other

    @staticmethod
    def extract(*objects):
        """Extract .value from DynamicNumber-likes, pass through the rest."""
        return tuple(o.value if isinstance(o, DynamicNumber) else o for o in objects)
