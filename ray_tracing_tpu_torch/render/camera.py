"""Pinhole camera: pose + ray generation + interactive controls, on torch
tensors.

Counterpart of ``ray_tracing_tpu/render/camera.py``. The camera is an
immutable dataclass; move/rotate return a new Camera. Ray generation keeps
the reference renderer's degrees-as-radians quirk: ``screen_h =
2*tan(fov/2)`` with fov in DEGREES handed to tan (tan(15 rad) is about
-0.856, so screen_h is about -1.712, a negative height that flips the image
vertically). ``config.fov_degrees_bug=False`` gives a sane camera.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ray_tracing_tpu_torch.config import RenderConfig, DEFAULT_CONFIG
from ray_tracing_tpu_torch.device import resolve_device
from ray_tracing_tpu_torch.ops.vec import Vec3, div_scalar

UP, DOWN, LEFT, RIGHT = 0, 1, 2, 3  # movement directions


@dataclasses.dataclass(frozen=True)
class Camera:
    """5-DOF pose. `front` is carried explicitly because the reference's
    initial front {-1,-1,-1} is not consistent with its initial yaw=-90 /
    pitch=0: front only snaps to yaw/pitch after the first rotation."""

    pos: torch.Tensor    # (3,)
    front: torch.Tensor  # (3,)
    up: torch.Tensor     # (3,)
    yaw: torch.Tensor    # () degrees
    pitch: torch.Tensor  # () degrees

    @staticmethod
    def default(device=None) -> "Camera":
        # The initial front is left UNNORMALISED, and move() steps along it
        # raw, so moves before the first rotation are sqrt(3) times a later
        # step. Ray generation normalises on its own. device=None means
        # the card.
        device = resolve_device(device)

        def t(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        return Camera(
            pos=t([5.0, 5.0, 5.0]),
            front=t([-1.0, -1.0, -1.0]),
            up=t([0.0, 1.0, 0.0]),
            yaw=t(-90.0),
            pitch=t(0.0),
        )

    @property
    def device(self) -> torch.device:
        return self.pos.device

    def to(self, device) -> "Camera":
        device = torch.device(device)
        if self.pos.device == device:
            return self
        return Camera(**{
            f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)
        })

    @property
    def pos_v(self) -> Vec3:
        return Vec3(self.pos[0], self.pos[1], self.pos[2])

    @property
    def front_v(self) -> Vec3:
        return Vec3(self.front[0], self.front[1], self.front[2])

    @property
    def up_v(self) -> Vec3:
        return Vec3(self.up[0], self.up[1], self.up[2])


def screen_height(config: RenderConfig) -> float:
    """2*tan(fov/2) in Python float64, with the degrees bug on by default."""
    half = config.fov / 2.0
    if not config.fov_degrees_bug:
        half = math.radians(half)
    return 2.0 * math.tan(half)


def _basis(camera: Camera):
    w = (-camera.front_v).normalize()
    ub = camera.up_v.cross(w).normalize()
    vb = w.cross(ub)
    return ub, vb, w


def camera_pack(camera: Camera, aspect: float, config: RenderConfig = DEFAULT_CONFIG):
    """The 16 floats the kernels read: pos | u basis | v basis | w basis |
    screen width | screen height | 0 | 0, on the camera's device."""
    ub, vb, w = _basis(camera)
    sh = screen_height(config)
    sw = aspect * sh
    dev = camera.pos.device
    tail = torch.tensor([sw, sh, 0.0, 0.0], dtype=torch.float32, device=dev)
    return torch.cat([
        camera.pos.to(torch.float32),
        torch.stack([ub.x, ub.y, ub.z, vb.x, vb.y, vb.z, w.x, w.y, w.z]),
        tail,
    ]).contiguous()


def ray_through_screen(camera: Camera, u, v, aspect_ratio,
                       config: RenderConfig = DEFAULT_CONFIG):
    """Rays through normalised screen coordinates u, v (batch-shaped
    tensors). Returns (ro, rd); rd is UNNORMALISED: shading uses the raw
    direction and only the trace normalises."""
    ub, vb, w = _basis(camera)
    sh = screen_height(config)
    sw = aspect_ratio * sh
    dev = camera.pos.device
    u = torch.as_tensor(u, dtype=torch.float32, device=dev)
    v = torch.as_tensor(v, dtype=torch.float32, device=dev)
    cu = (u - 0.5) * sw
    cv = (v - 0.5) * sh
    rd = Vec3(
        cu * ub.x + cv * vb.x - w.x,
        cu * ub.y + cv * vb.y - w.y,
        cu * ub.z + cv * vb.z - w.z,
    )
    ro = camera.pos_v.broadcast_to(rd.shape)
    return ro, rd


def pixel_grid(width: int, height: int, row0=0, norm_height: int | None = None,
               device=None):
    """Normalised (u, v) for every pixel with the reference's flips:
    u = 1 - x/(W-1), v = 1 - y/(H-1). row0/norm_height select a
    `height`-row slice starting at global row `row0` of a norm_height-tall
    frame. Divisors are guarded for 1-pixel dimensions. The one copy of
    this formula in plain PyTorch (the estimator's _tile_uv calls it); the
    CUDA kernel has the other. device=None means the card."""
    device = resolve_device(device)
    if norm_height is None:
        norm_height = height
    x = torch.arange(width, dtype=torch.float32, device=device)
    y = torch.arange(height, dtype=torch.float32, device=device) + float(row0)
    u = 1.0 - div_scalar(x, float(max(width - 1, 1)))
    v = 1.0 - div_scalar(y, float(max(norm_height - 1, 1)))
    uu = u[None, :].expand(height, width)
    vv = v[:, None].expand(height, width)
    return uu, vv


def move(camera: Camera, direction: int, speed: float | None = None,
         config: RenderConfig = DEFAULT_CONFIG) -> Camera:
    """WASD movement: UP/DOWN along front, LEFT/RIGHT along
    normalize(cross(front, up))."""
    if speed is None:
        speed = config.move_speed
    front = camera.front_v
    right = front.cross(camera.up_v).normalize()
    delta = {
        UP: front * speed,
        DOWN: front * -speed,
        LEFT: right * -speed,
        RIGHT: right * speed,
    }[direction]
    new_pos = camera.pos + torch.stack([delta.x, delta.y, delta.z])
    return dataclasses.replace(camera, pos=new_pos)


def rotate(camera: Camera, dx: float, dy: float,
           config: RenderConfig = DEFAULT_CONFIG) -> Camera:
    """Mouse-look. dx, dy are raw mouse deltas in pixels (dy already in the
    'screen-up' sense). Sensitivity 0.1, pitch clamped to +/-89 degrees."""
    yaw = camera.yaw + dx * config.mouse_sensitivity
    pitch = torch.clamp(camera.pitch + dy * config.mouse_sensitivity, -89.0, 89.0)
    yaw_r = torch.deg2rad(yaw)
    pitch_r = torch.deg2rad(pitch)
    front = Vec3(
        torch.cos(yaw_r) * torch.cos(pitch_r),
        torch.sin(pitch_r),
        torch.sin(yaw_r) * torch.cos(pitch_r),
    ).normalize()
    return dataclasses.replace(
        camera, yaw=yaw, pitch=pitch,
        front=torch.stack([front.x, front.y, front.z]),
    )
