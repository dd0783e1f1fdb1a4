"""
ShaderCamera — quaternion camera with second-order-smoothed parameters.

Port of shaderflow_tpu/camera.py, host side, line for line: every parameter
is a ShaderDynamics (position, separation, rotation quaternion, zenith,
zoom, isometric, focal length, orbital, dolly); three modes govern
interaction and three projections the device-side ray math
(ops/cameralib.py). The `iCameraTrivial` static marks the untouched
orientation with perspective projection, where the ray math is separable.
The HUD panel hooks are not ported.
"""

from __future__ import annotations

import math
from enum import Enum
from typing import Iterable

import numpy as np

from shaderflow_tpu_torch.message import ShaderMessage
from shaderflow_tpu_torch.variable import ShaderVariable, StaticUniform
from shaderflow_tpu_torch.dynamics import ShaderDynamics
from shaderflow_tpu_torch.keyboard import ShaderKeyboard
from shaderflow_tpu_torch.module import ShaderModule
from shaderflow_tpu_torch.ops import quaternion as qt
from shaderflow_tpu_torch.ops.dynamics import DynamicNumber


class GlobalBasis:
    Origin = np.zeros(3)
    Null = np.zeros(3)
    Up = np.array([0.0, 1.0, 0.0])
    Down = np.array([0.0, -1.0, 0.0])
    Left = np.array([-1.0, 0.0, 0.0])
    Right = np.array([1.0, 0.0, 0.0])
    Forward = np.array([0.0, 0.0, 1.0])
    Backward = np.array([0.0, 0.0, -1.0])


class CameraProjection(Enum):
    Perspective = 0
    Stereoscopic = 1
    Equirectangular = 2

    @classmethod
    def _missing_(cls, value):
        aliases = {
            "perspective": cls.Perspective, "default": cls.Perspective,
            "stereoscopic": cls.Stereoscopic, "stereo": cls.Stereoscopic,
            "vr": cls.Stereoscopic, "sbs": cls.Stereoscopic,
            "spherical": cls.Equirectangular, "equirectangular": cls.Equirectangular,
            "360": cls.Equirectangular,
        }
        if value in aliases:
            return aliases[value]
        raise ValueError(f"{value} is not a valid {cls.__name__}")


class CameraMode(Enum):
    FreeCamera = 0
    Camera2D = 1
    Spherical = 2

    @classmethod
    def _missing_(cls, value):
        aliases = {
            "free": cls.FreeCamera, "freecamera": cls.FreeCamera,
            "2d": cls.Camera2D, "plane": cls.Camera2D, "flat": cls.Camera2D,
            "spherical": cls.Spherical, "aligned": cls.Spherical,
        }
        if value in aliases:
            return aliases[value]
        raise ValueError(f"{value} is not a valid {cls.__name__}")


class ShaderCamera(ShaderModule):
    name: str = "iCamera"

    def __init__(self, scene=None, name: str = "iCamera",
                 mode=CameraMode.Camera2D, projection=CameraProjection.Perspective, **kwargs):
        self.mode = mode
        self.projection = projection
        super().__init__(scene=scene, name=name, **kwargs)

    # mode/projection coerce on ASSIGNMENT (not just construction): a raw
    # string stored by `camera.mode = "free"` would silently fail every
    # `mode == CameraMode.X` comparison downstream (the reference coerces
    # via attrs converters, camera.py:71-90).

    @property
    def mode(self) -> CameraMode:
        return self._mode

    @mode.setter
    def mode(self, value) -> None:
        self._mode = CameraMode(value)

    @property
    def projection(self) -> CameraProjection:
        return self._projection

    @projection.setter
    def projection(self, value) -> None:
        self._projection = CameraProjection(value)

    def build(self) -> None:
        scene = self.scene
        name = self.name
        self.position = ShaderDynamics(scene=scene, name=f"{name}Position", real=True,
                                       frequency=4, zeta=1, response=0,
                                       value=GlobalBasis.Origin.copy())
        self.separation = ShaderDynamics(scene=scene, name=f"{name}Separation", real=True,
                                         frequency=0.5, zeta=1, response=0, value=0.05)
        self.rotation = ShaderDynamics(scene=scene, name=f"{name}Rotation", real=True,
                                       primary=False, frequency=5, zeta=1, response=0,
                                       value=qt.IDENTITY.copy())
        self.zenith = ShaderDynamics(scene=scene, name=f"{name}Zenith", real=True,
                                     frequency=1, zeta=1, response=0,
                                     value=GlobalBasis.Up.copy())
        self.zoom = ShaderDynamics(scene=scene, name=f"{name}Zoom", real=True,
                                   frequency=3, zeta=1, response=0, value=1.0)
        self.isometric = ShaderDynamics(scene=scene, name=f"{name}Isometric", real=True,
                                        frequency=1, zeta=1, response=0, value=0.0)
        self.focus = ShaderDynamics(scene=scene, name=f"{name}FocalLength", real=True,
                                    frequency=1, zeta=1, response=0, value=1.0)
        self.orbital = ShaderDynamics(scene=scene, name=f"{name}Orbital", real=True,
                                      frequency=1, zeta=1, response=0, value=0.0)
        self.dolly = ShaderDynamics(scene=scene, name=f"{name}Dolly", real=True,
                                    frequency=1, zeta=1, response=0, value=0.0)

    def load_state(self, state: dict) -> None:
        """Carry a reference run's orientation: "rotation" (4,) is the
        quaternion the camera holds from the first frame on (value, target
        and the initial value setup() returns to)."""
        unknown = set(state) - {"rotation"}
        if unknown:
            raise KeyError(f"ShaderCamera carries no state named {sorted(unknown)}")
        if "rotation" in state:
            self.rotation.set(np.asarray(state["rotation"], np.float64))

    # -- field of view <-> zoom (camera.py:187-194) --------------------------

    @property
    def fov(self) -> float:
        """Vertical field of view in degrees, considering isometric factor."""
        return 2.0 * math.degrees(math.atan(float(self.zoom.value) - float(self.isometric.value)))

    @fov.setter
    def fov(self, value: float) -> None:
        self.zoom.target = math.tan(math.radians(value) / 2.0) + float(self.isometric.value)

    # -- uniforms ------------------------------------------------------------

    @property
    def trivial(self) -> bool:
        """True while the camera orientation is the untouched global basis
        and the projection is perspective: the device ray math then takes
        the separable fast path (ops/cameralib.project_trivial). Exposed as
        a static uniform — the engine re-specializes when it flips."""
        return (self.projection == CameraProjection.Perspective
                and bool(np.allclose(self.rotation.value, qt.IDENTITY, atol=1e-7)))

    def _basis(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, bool]:
        """Per-frame-cached (right, up, forward, trivial): three quaternion
        rotations + an allclose dominate the host pipeline sweep otherwise."""
        key = self.rotation.value.tobytes()
        cached = getattr(self, "_basis_cache", None)
        if cached is None or cached[0] != key:
            self._basis_cache = (key, self.right, self.up, self.forward, self.trivial)
        return self._basis_cache[1:]

    def pipeline(self) -> Iterable[ShaderVariable]:
        right, up, forward, trivial = self._basis()
        yield StaticUniform("int", f"{self.name}Mode", self.mode.value)
        yield StaticUniform("int", f"{self.name}Projection", self.projection.value)
        yield StaticUniform("bool", f"{self.name}Trivial",
                            trivial and self.projection == CameraProjection.Perspective)
        yield self.uniform("vec3", f"{self.name}Right", right)
        yield self.uniform("vec3", f"{self.name}Upward", up)
        yield self.uniform("vec3", f"{self.name}Forward", forward)

    # -- vector actions (camera.py:209-235) ----------------------------------

    def move(self, direction, absolute: bool = False) -> "ShaderCamera":
        direction = np.asarray(direction, dtype=np.float64)
        if absolute:
            self.position.target = direction.copy()
        else:
            self.position.target = self.position.target + direction
        return self

    def rotate(self, direction, degrees: float = 0.0) -> "ShaderCamera":
        """Cumulative rotation around an axis; renormalized quaternion."""
        rotation = qt.qmul(qt.quaternion(np.asarray(direction, np.float64), degrees),
                           self.rotation.target)
        self.rotation.target = qt.qnormalize(rotation)
        return self

    def rotate2d(self, degrees: float = 0.0) -> "ShaderCamera":
        target = qt.rotate_vector(self.zenith.value, qt.quaternion(self.forward_target, degrees))
        return self.align(self.up_target, target)

    def align(self, a, b, degrees: float = 0.0) -> "ShaderCamera":
        a, b = DynamicNumber.extract(a, b)
        return self.rotate(
            qt.unit_vector(np.cross(a, b)),
            qt.angle(a, b) - degrees,
        )

    def look(self, target) -> "ShaderCamera":
        return self.align(self.forward_target, np.asarray(target) - self.position.target)

    # -- interaction (camera.py:240-355) -------------------------------------

    def update(self) -> None:
        dt = abs(self.scene.dt or self.scene.rdt)
        keyboard = self.scene.keyboard
        keys = ShaderKeyboard.Keys

        move = GlobalBasis.Null.copy()
        if self.mode == CameraMode.Camera2D:
            if keyboard(keys.W): move += GlobalBasis.Up
            if keyboard(keys.A): move += GlobalBasis.Left
            if keyboard(keys.S): move += GlobalBasis.Down
            if keyboard(keys.D): move += GlobalBasis.Right
        else:
            if keyboard(keys.W): move += GlobalBasis.Forward
            if keyboard(keys.A): move += GlobalBasis.Left
            if keyboard(keys.S): move += GlobalBasis.Backward
            if keyboard(keys.D): move += GlobalBasis.Right
            if keyboard(keys.SPACE): move += GlobalBasis.Up
            if keyboard(keys.LEFT_SHIFT): move += GlobalBasis.Down
        if move.any():
            move = qt.rotate_vector(move, self.rotation.target)
            self.move(2 * qt.unit_vector(move) * float(self.zoom.value) * dt)

        rotate = GlobalBasis.Null.copy()
        if keyboard(keys.Q): rotate += GlobalBasis.Forward
        if keyboard(keys.E): rotate += GlobalBasis.Backward
        if rotate.any():
            self.rotate(qt.rotate_vector(rotate, self.rotation.target), 45 * dt)

        if self.mode == CameraMode.Spherical:
            self.align(self.right_target, self.zenith.target, 90)

        if keyboard(keys.T):
            self.isometric.target = min(max(0.0, float(self.isometric.target) + 0.5 * dt), 1.0)
        if keyboard(keys.G):
            self.isometric.target = min(max(0.0, float(self.isometric.target) - 0.5 * dt), 1.0)

    def apply_zoom(self, value: float) -> None:
        """Multiplicative zoom so zoom-in then zoom-out returns exactly."""
        if value > 0:
            self.zoom.target = self.zoom.target * (1 + value)
        else:
            self.zoom.target = self.zoom.target / (1 - value)

    def handle(self, message) -> None:
        keys = ShaderKeyboard.Keys

        drag_like = (isinstance(message, ShaderMessage.Mouse.Drag)
                     or (isinstance(message, ShaderMessage.Mouse.Position) and self.scene.exclusive))
        if drag_like:
            if not (self.scene.mouse_buttons.get(1) or self.scene.exclusive):
                return
            if self.mode == CameraMode.FreeCamera:
                self.rotate(self.up * float(self.zoom.value), degrees=message.du * 100)
                self.rotate(self.right * float(self.zoom.value), degrees=-message.dv * 100)
            elif self.mode == CameraMode.Camera2D:
                move = (message.du * GlobalBasis.Right) + (message.dv * GlobalBasis.Up)
                move = qt.rotate_vector(move, self.rotation.target)
                self.move(move * (1 if self.scene.exclusive else -1) * float(self.zoom.value))
            elif self.mode == CameraMode.Spherical:
                up = 1 if qt.angle(self.up_target, self.zenith.value) < 90 else -1
                self.rotate(self.zenith.value * up * float(self.zoom.value), degrees=message.du * 100)
                self.rotate(self.right * float(self.zoom.value), degrees=-message.dv * 100)

        elif isinstance(message, ShaderMessage.Mouse.Scroll):
            self.apply_zoom(-0.05 * message.dy)

        elif isinstance(message, ShaderMessage.Keyboard.Press) and message.action == 1:
            if message.key == keys.NUMBER_1:
                self.mode = CameraMode.FreeCamera
            elif message.key == keys.NUMBER_2:
                self.align(self.right_target, GlobalBasis.Right)
                self.align(self.up_target, GlobalBasis.Up)
                self.mode = CameraMode.Camera2D
                self.position.target[2] = 0
                self.isometric.target = 0.0
                self.zoom.target = 1.0
            elif message.key == keys.NUMBER_3:
                self.mode = CameraMode.Spherical
            elif message.key in (keys.I, keys.J, keys.K):
                self.zenith.target = {
                    keys.I: GlobalBasis.Right, keys.J: GlobalBasis.Up,
                    keys.K: GlobalBasis.Forward}[message.key].copy()
                self.align(self.forward_target, self.zenith.target)
                self.align(self.up_target, self.zenith.target, 90)
                self.align(self.right_target, self.zenith.target, 90)
            elif message.key == keys.P:
                self.projection = CameraProjection((self.projection.value + 1) % 3)

    # -- basis directions (camera.py:360-447) ---------------------------------

    @property
    def right(self) -> np.ndarray:
        return qt.rotate_vector(GlobalBasis.Right, self.rotation.value)

    @property
    def right_target(self) -> np.ndarray:
        return qt.rotate_vector(GlobalBasis.Right, self.rotation.target)

    @property
    def left(self) -> np.ndarray:
        return -self.right

    @property
    def left_target(self) -> np.ndarray:
        return -self.right_target

    @property
    def up(self) -> np.ndarray:
        return qt.rotate_vector(GlobalBasis.Up, self.rotation.value)

    @property
    def up_target(self) -> np.ndarray:
        return qt.rotate_vector(GlobalBasis.Up, self.rotation.target)

    @property
    def down(self) -> np.ndarray:
        return -self.up

    @property
    def down_target(self) -> np.ndarray:
        return -self.up_target

    @property
    def forward(self) -> np.ndarray:
        return qt.rotate_vector(GlobalBasis.Forward, self.rotation.value)

    @property
    def forward_target(self) -> np.ndarray:
        return qt.rotate_vector(GlobalBasis.Forward, self.rotation.target)

    @property
    def backward(self) -> np.ndarray:
        return -self.forward

    @property
    def backward_target(self) -> np.ndarray:
        return -self.forward_target

    # Position component accessors

    @property
    def x(self) -> float:
        return float(self.position.value[0])

    @x.setter
    def x(self, value: float) -> None:
        self.position.target[0] = value

    @property
    def y(self) -> float:
        return float(self.position.value[1])

    @y.setter
    def y(self, value: float) -> None:
        self.position.target[1] = value

    @property
    def z(self) -> float:
        return float(self.position.value[2])

    @z.setter
    def z(self, value: float) -> None:
        self.position.target[2] = value
