"""Perspective camera with interactive control, as an immutable JAX pytree.

A redesign of the reference's `class Camera` (reference
camera.h:28-177). Differences by design:
  - functional: `translate`/`rotate` return a new Camera instead of mutating
    (the dirty-flag `IsUpdated` protocol of camera.h:134 becomes value
    equality / explicit reset in the progressive renderer);
  - `generate_rays` is batched over a whole pixel grid at once and is
    differentiable w.r.t. the camera parameters (for camera-pose gradients);
  - the view matrix is a 3x3 row-stack [u; v; w] (the reference's 4x4 is
    never used beyond its 3x3 block, camera.h:49-54).

DOF fields (lens_radius/focal_distance) are carried like the reference does
(stored but unused in ray generation; camera.h:68 TODO) — and here actually
implemented: when lens_radius > 0, thin-lens sampling is applied.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax.numpy as jnp
from jax import Array

from pathtracer.utils.pytree import pytree_dataclass, static_field
from pathtracer.ops import sampling, vecmath as vm


@pytree_dataclass
class Camera:
    pos: Array  # (3,) eye position
    view: Array  # (3,3) rows = [u (right), v (up), w (forward)]
    px_x: Array  # (3,) image-plane step for +1 pixel in x
    px_y: Array  # (3,) image-plane step for +1 pixel in y
    first_ray_dir: Array  # (3,) direction to the upper-left corner pixel
    dist: Array  # () distance eye -> image plane
    hfov: Array  # () horizontal fov, degrees
    vfov: Array  # () vertical fov, degrees
    lens_radius: Array  # () thin-lens aperture radius (0 = pinhole)
    focal_distance: Array  # () focus plane distance
    width: int = static_field(640)
    height: int = static_field(480)
    # Static: compiles the thin-lens path only when DOF is actually on.
    use_dof: bool = static_field(False)


def _image_plane(view: Array, dist: Array, hfov: Array, vfov: Array,
                 width: int, height: int) -> tuple[Array, Array, Array]:
    """Recompute the per-pixel image-plane basis (camera.h:144-158 semantics)."""
    u, v, w = view[0], view[1], view[2]
    deg = jnp.pi / 180.0
    px_x = u * (dist * 2.0 * jnp.tan(hfov * 0.5 * deg) / width)
    px_y = v * (dist * 2.0 * jnp.tan(vfov * 0.5 * deg) / height)
    first_ray_dir = w * dist + px_y * (height * 0.5) - px_x * (width * 0.5)
    return px_x, px_y, first_ray_dir


def make_camera(
    eye: Any,
    look_at: Any,
    up: Any,
    width: int,
    height: int,
    fov: float = 60.0,
    lens_radius: float = 0.0,
    focal_distance: float = 0.0,
) -> Camera:
    """Build a camera (reference camera.h:31-57 semantics).

    fov is the horizontal field of view in degrees; the vertical fov is
    derived from the aspect ratio exactly as the reference does
    (camera.h:34-36).
    """
    eye = jnp.asarray(eye, jnp.float32)
    look_at = jnp.asarray(look_at, jnp.float32)
    up = jnp.asarray(up, jnp.float32)

    aspect = float(height) / float(width)
    hfov = jnp.asarray(fov, jnp.float32)
    vfov = hfov * aspect

    to_target = look_at - eye
    dist = vm.length(to_target)
    w = to_target / dist
    v = vm.normalize(up - vm.dot(up, w) * w)
    u = vm.normalize(vm.cross(w, v))
    view = jnp.stack([u, v, w])

    px_x, px_y, first_ray_dir = _image_plane(view, dist, hfov, vfov, width, height)
    return Camera(
        pos=eye,
        view=view,
        px_x=px_x,
        px_y=px_y,
        first_ray_dir=first_ray_dir,
        dist=dist,
        hfov=hfov,
        vfov=vfov,
        lens_radius=jnp.asarray(lens_radius, jnp.float32),
        focal_distance=jnp.asarray(focal_distance, jnp.float32),
        width=width,
        height=height,
        use_dof=bool(lens_radius > 0.0),
    )


def generate_rays(
    cam: Camera,
    px: Array,
    py: Array,
    jitter_u: Array,
    jitter_v: Array,
    lens_u: Array | None = None,
    lens_v: Array | None = None,
) -> tuple[Array, Array]:
    """Generate primary rays through pixel centers (px, py) + sub-pixel jitter.

    Batched form of camera.h:66-72: dir = first_ray_dir - px_y*sy + px_x*sx.
    px/py/jitter_*: broadcastable (...,) arrays. Returns (origins, dirs),
    each (..., 3).

    If the camera has a positive lens radius and lens uniforms are given,
    applies thin-lens depth of field (implementing the reference's TODO at
    camera.h:68): the origin is jittered on the lens disk and the direction
    re-aimed at the focal-plane point.
    """
    sx = px.astype(jnp.float32) + jitter_u
    sy = py.astype(jnp.float32) + jitter_v
    d = (
        cam.first_ray_dir
        - cam.px_y * sy[..., None]
        + cam.px_x * sx[..., None]
    )
    d = vm.normalize(d)
    o = jnp.broadcast_to(cam.pos, d.shape)

    if cam.use_dof and lens_u is not None and lens_v is not None:
        # Thin-lens sampling, compiled in only for DOF cameras (use_dof is a
        # static pytree field set when lens_radius > 0).
        dx, dy = sampling.concentric_sample_disk(lens_u, lens_v)
        u_axis, v_axis = cam.view[0], cam.view[1]
        offset = (
            u_axis * (dx * cam.lens_radius)[..., None]
            + v_axis * (dy * cam.lens_radius)[..., None]
        )
        # Point on the plane of focus along the original ray.
        cos_w = vm.dot(d, cam.view[2])[..., None]
        ft = cam.focal_distance / jnp.maximum(cos_w, 1e-6)
        focus_p = o + d * ft
        o = o + offset
        d = vm.normalize(focus_p - o)
    return o, d


def pixel_grid(cam: Camera) -> tuple[Array, Array]:
    """Integer pixel coordinate grids, each (height, width)."""
    ys, xs = jnp.mgrid[0 : cam.height, 0 : cam.width]
    return xs, ys


def translate(cam: Camera, delta: Any) -> Camera:
    """Move the eye along the current view axes (camera.h:79-90).

    delta = (right, up, forward) amounts. Image-plane basis is unchanged,
    exactly as in the reference.
    """
    delta = jnp.asarray(delta, jnp.float32)
    u, v, w = cam.view[0], cam.view[1], cam.view[2]
    new_pos = cam.pos + u * delta[0] + v * delta[1] + w * delta[2]
    return dataclasses.replace(cam, pos=new_pos)


def rotate(cam: Camera, theta: Any) -> Camera:
    """Rotate the view by theta=(tx, ty) radians (camera.h:97-129 semantics).

    The reference composes an x-axis rotation (driven by theta.y) and a
    y-axis rotation (driven by theta.x) onto the view matrix; z rotation is
    unsupported there and here.
    """
    theta = jnp.asarray(theta, jnp.float32)
    tx, ty = theta[0], theta[1]
    ctx, stx = jnp.cos(tx), jnp.sin(tx)
    cty, sty = jnp.cos(ty), jnp.sin(ty)
    rx = jnp.array(
        [[1.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]], jnp.float32
    )
    rx = rx.at[1, 1].set(cty).at[1, 2].set(-sty).at[2, 1].set(sty).at[2, 2].set(cty)
    ry = jnp.array(
        [[0.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 0.0]], jnp.float32
    )
    ry = ry.at[0, 0].set(ctx).at[0, 2].set(stx).at[2, 0].set(-stx).at[2, 2].set(ctx)
    hp = jnp.matmul  # 3x3 composes need full f32, not bf16 matmul default
    view = hp(hp(rx, ry, precision="highest"), cam.view, precision="highest")
    px_x, px_y, first_ray_dir = _image_plane(
        view, cam.dist, cam.hfov, cam.vfov, cam.width, cam.height
    )
    return dataclasses.replace(cam, view=view, px_x=px_x, px_y=px_y, first_ray_dir=first_ray_dir)
