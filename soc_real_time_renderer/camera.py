"""Cameras.

Analog of the reference's ``src/graphics/camera.{hpp,cpp}``:

* :class:`Camera3D` — perspective camera with the Vulkan Y-flip the
  reference applies (``camera.cpp:6-10``), fov 90, near 0.1, far 1000
  (``camera.hpp:18-19``).
* :class:`ControlledCamera3D` — the fly camera (``camera.cpp:23-57``):
  yaw/pitch mouse-look with pitch clamped to ±1.56825555556 rad, WASD +
  Space/Ctrl movement, sprint.  Input arrives through :class:`InputState`
  (the headless stand-in for the GLFW window's key/cursor state machine,
  ``window.cpp:107-188``).

Host-side (numpy): camera updates are tiny and feed the jitted frame as
:class:`~.config.CameraMatrices` leaves.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .config import CameraMatrices, plastic_jitter
from .utils import mathutil as mu

MAX_ROT = 1.56825555556  # camera.cpp:37


@dataclass
class InputState:
    """Headless input snapshot — replaces AppWindow's key/cursor queries."""
    forward: bool = False   # W
    back: bool = False      # S
    left: bool = False      # A
    right: bool = False     # D
    up: bool = False        # Space
    down: bool = False      # Ctrl
    sprint: bool = False    # Shift
    cursor_dx: float = 0.0
    cursor_dy: float = 0.0
    cursor_captured: bool = True


@dataclass
class Camera3D:
    fov: float = 90.0
    aspect: float = 1.0
    near_clip: float = 0.1
    far_clip: float = 1000.0
    proj_mat: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float32))
    view_mat: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float32))

    def resize(self, size_x: int, size_y: int) -> None:
        self.aspect = float(size_x) / float(size_y)
        self.proj_mat = mu.perspective(self.fov, self.aspect,
                                       self.near_clip, self.far_clip)

    def get_vp(self) -> np.ndarray:
        return (self.proj_mat @ self.view_mat).astype(np.float32)

    def get_view(self) -> np.ndarray:
        return self.view_mat


@dataclass
class ControlledCamera3D:
    camera: Camera3D = field(default_factory=Camera3D)
    mouse_sens: float = 0.1
    sprint_speed: float = 8.0
    position: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    rotation: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))

    def update(self, inp: InputState, dt: float) -> None:
        """camera.cpp:23-57 semantics."""
        if inp.cursor_captured:
            self.rotation[0] += inp.cursor_dx * self.mouse_sens * 1e-4 * self.camera.fov
            self.rotation[1] += inp.cursor_dy * self.mouse_sens * 1e-4 * self.camera.fov
        self.rotation[1] = np.clip(self.rotation[1], -MAX_ROT, MAX_ROT)

        rx, ry = float(self.rotation[0]), float(self.rotation[1])
        forward = np.array([np.cos(rx) * np.cos(ry), -np.sin(ry),
                            np.sin(rx) * np.cos(ry)], np.float32)
        forward /= np.linalg.norm(forward)
        up = np.array([0.0, 1.0, 0.0], np.float32)
        right = np.cross(forward, up)
        right /= np.linalg.norm(right)

        move = np.zeros(3, np.float32)
        if inp.cursor_captured:
            if inp.forward:
                move += forward
            if inp.back:
                move -= forward
            # Reference binds move_nx=D to +right and move_px=A to
            # -right (camera.cpp:49-50, keybinds camera.hpp:38-47).
            if inp.right:
                move += right
            if inp.left:
                move -= right
            if inp.up:
                move += up
            if inp.down:
                move -= up

        speed = self.sprint_speed if inp.sprint else 2.0
        self.position = (self.position + move * dt * speed * 7.5).astype(np.float32)
        self.camera.view_mat = mu.look_at(self.position,
                                          self.position + forward, up)


def camera_matrices(camera: Camera3D, position, jitter_index: int | None,
                    width: int, height: int) -> CameraMatrices:
    """Build the jittered CameraMatrices set, as Application::update does
    (application.cpp:113-161): plastic-sequence jitter added to
    proj[0,3]/proj[1,3] (glm's [3][0]/[3][1])."""
    proj = camera.proj_mat.copy()
    if jitter_index is not None:
        j = np.asarray(plastic_jitter(jitter_index, width, height))
        proj[0, 3] += j[0]
        proj[1, 3] += j[1]
    else:
        j = np.zeros(2, np.float32)
    return CameraMatrices.from_proj_view(proj, camera.view_mat, position, j)
