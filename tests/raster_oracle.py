"""Naive numpy rasterizer oracle shared by the raster tests and
chip_smoke.py.

Reference semantics (explicit perspective divide, screen-space
barycentric coverage, LESS depth test) matching the Vulkan raster state
of the reference renderer (src/graphics/tasks/depth_prepass.inl:38-46).
Triangles are drawn in index order; a strictly nearer fragment wins, so
exact depth ties keep the lowest triangle id.
"""
import numpy as np

from soc_real_time_renderer.utils import mathutil as mu


def naive_raster(clip, indices, width, height, cull="front"):
    """Reference rasterizer in float64: explicit perspective divide,
    screen-space barycentric coverage, affine z interpolation, one
    triangle at a time over its pixel bbox.  Requires all w > 0."""
    clip = np.asarray(clip, np.float64)
    depth = np.full((height, width), np.inf)
    tri = np.full((height, width), -1, np.int32)
    for t, (i0, i1, i2) in enumerate(np.asarray(indices)):
        v = clip[[i0, i1, i2]]
        w = v[:, 3]
        assert np.all(w > 0), "naive rasterizer needs w > 0"
        sx = (v[:, 0] / w * 0.5 + 0.5) * width
        sy = (v[:, 1] / w * 0.5 + 0.5) * height
        z = v[:, 2] / w
        area = ((sx[1] - sx[0]) * (sy[2] - sy[0])
                - (sy[1] - sy[0]) * (sx[2] - sx[0]))
        if cull == "front" and area >= 0:
            continue
        if cull == "back" and area <= 0:
            continue
        if area == 0:
            continue
        x0 = int(max(0, np.floor(sx.min())))
        x1 = int(min(width, np.ceil(sx.max()) + 1))
        y0 = int(max(0, np.floor(sy.min())))
        y1 = int(min(height, np.ceil(sy.max()) + 1))
        if x1 <= x0 or y1 <= y0:
            continue
        px = np.arange(x0, x1)[None, :] + 0.5
        py = np.arange(y0, y1)[:, None] + 0.5
        b = []
        for k in range(3):
            a, bb = (k + 1) % 3, (k + 2) % 3
            b.append(((sx[bb] - sx[a]) * (py - sy[a])
                      - (sy[bb] - sy[a]) * (px - sx[a])) / area)
        zp = b[0] * z[0] + b[1] * z[1] + b[2] * z[2]
        dwin = depth[y0:y1, x0:x1]
        win = ((b[0] >= 0) & (b[1] >= 0) & (b[2] >= 0)
               & (zp >= 0) & (zp <= 1) & (zp < dwin))
        dwin[win] = zp[win]
        tri[y0:y1, x0:x1][win] = t
    depth[~np.isfinite(depth)] = 1.0
    return depth, tri


def make_clip(verts_view, fov=90.0, aspect=1.0, near=0.1, far=100.0):
    p = mu.perspective(fov, aspect, near, far)
    v = np.asarray(verts_view, np.float32)
    return (v @ p[:, :3].T + p[:, 3]).astype(np.float32)


def soup(n, seed, extent=0.5, aspect=1.0):
    """Seeded triangle soup in front of the camera: n triangles with
    centres in a view-space box and vertex offsets within +-extent.
    Returns (clip (3n, 4) f32, planar clip (3, 4, n) f32)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform([-1.0 * aspect, -1.0, -4.0],
                          [1.0 * aspect, 1.0, -2.0], (n, 3))
    offs = rng.uniform(-extent, extent, (n, 3, 3))
    verts = (centers[:, None, :] + offs).reshape(-1, 3).astype(np.float32)
    clip = make_clip(verts, aspect=aspect)
    return clip, np.ascontiguousarray(clip.reshape(n, 3, 4).transpose(1, 2, 0))


def regular_soup(n, seed, size=0.05, aspect=1.0):
    """Seeded soup of well-shaped triangles: each a jittered equilateral
    triangle (circumradius in [size/2, size], corners within 17 degrees
    of even spacing) on a plane tilted at most 45 degrees per axis from
    facing the camera, so no sliver reaches the screen.  Slivers are a
    property of the float32 setup (their depth error grows with screen
    size), not of the resolve; this soup measures the resolve.
    Returns (clip (3n, 4) f32, planar clip (3, 4, n) f32)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform([-1.0 * aspect, -1.0, -4.0],
                          [1.0 * aspect, 1.0, -2.0], (n, 3))
    r = rng.uniform(0.5, 1.0, (n, 1)) * size
    th = (rng.uniform(0.0, 2 * np.pi, (n, 1))
          + np.arange(3)[None, :] * (2 * np.pi / 3)
          + rng.uniform(-0.3, 0.3, (n, 3)))
    x, y = r * np.cos(th), r * np.sin(th)
    slope = rng.uniform(-1.0, 1.0, (n, 2))
    z = slope[:, :1] * x + slope[:, 1:] * y
    verts = (centers[:, None, :] + np.stack([x, y, z], -1)).reshape(-1, 3)
    clip = make_clip(verts.astype(np.float32), aspect=aspect)
    return clip, np.ascontiguousarray(clip.reshape(n, 3, 4).transpose(1, 2, 0))
