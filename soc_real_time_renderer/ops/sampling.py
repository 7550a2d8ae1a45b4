"""Image sampling ops (the sampler-object replacement).

The reference binds Vulkan samplers per texture (linear+aniso16 repeat
for materials, ``texture.cpp:100-117``; linear clamp for screen passes;
a comparison sampler for shadows, ``renderer.cpp:54-69``).  Here each
sampler becomes a pure gather-based function in PLANAR layout
(components on leading axes):

* :func:`sample_screen` — bilinear/nearest from planar (C, H, W) images
  with clamp-to-edge; uv is (2, ...) planar.  The full-screen-pass
  sampler (material textures use the packed atlas in ops/gbuffer.py).
* :func:`shift` — constant-offset resampling for fixed-tap filters
  (blurs, TAA neighbourhoods): pure pad+slice, NO gathers.
* :func:`sample_shadow_cmp` — 2x2 bilinear-of-comparisons with LESS op
  and opaque-white border (``renderer.cpp:54-69``).
* :func:`grid_uv` — planar (2, H, W) pixel-centre uv grid.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def grid_uv(h, w):
    """(2, h, w) pixel-centre uv in [0,1]."""
    ux = (jnp.arange(w, dtype=jnp.float32) + 0.5) / w
    uy = (jnp.arange(h, dtype=jnp.float32) + 0.5) / h
    u = jnp.broadcast_to(ux[None, :], (h, w))
    v = jnp.broadcast_to(uy[:, None], (h, w))
    return jnp.stack([u, v])


def shift(img, dx: int, dy: int):
    """Clamp-to-edge integer shift of (..., H, W): out(y, x) =
    img(clamp(y + dy), clamp(x + dx)) — pure pad+slice, the gather-free
    path for fixed-tap filters."""
    H, W = img.shape[-2:]
    pads = [(0, 0)] * (img.ndim - 2) + [(max(-dy, 0), max(dy, 0)),
                                        (max(-dx, 0), max(dx, 0))]
    p = jnp.pad(img, pads, mode="edge")
    ys = max(-dy, 0) + dy   # start row in padded array
    xs = max(-dx, 0) + dx
    slices = tuple([slice(None)] * (img.ndim - 2)
                   + [slice(ys, ys + H), slice(xs, xs + W)])
    return p[slices]


def sample_screen(img, uv, method: str = "linear",
                  texel_coords: bool = False):
    """Sample planar image at planar uv with clamp-to-edge.

    img: (C, H, W) or (H, W); uv: (2, ...).  Returns (C, ...) / (...).

    texel_coords: uv is already (x, y) TEXEL coordinates (the value
    u*W - 0.5 would produce) — used by crop-slice sampling where the
    caller shifts full-image texel coords by an integer crop origin
    (exact in fp; a divide-by-crop-size round trip is not).
    """
    squeeze = img.ndim == 2
    if squeeze:
        img = img[None]
    C, H, W = img.shape
    # single-axis flat gathers over a (C, H*W) table
    flat = img.reshape(C, H * W)
    if texel_coords:
        x, y = uv[0], uv[1]
    else:
        x = uv[0] * W - 0.5
        y = uv[1] * H - 0.5
    if method == "nearest":
        xi = jnp.clip(jnp.round(x).astype(jnp.int32), 0, W - 1)
        yi = jnp.clip(jnp.round(y).astype(jnp.int32), 0, H - 1)
        # barrier: keep the index chain out of the gather fusion
        out = flat[:, jax.lax.optimization_barrier(yi * W + xi)]
    else:
        # ONE fat gather over a prestacked 4-corner table: gather cost
        # is per-INDEX and extra rows are cheap, so stacking
        # [img, img(x+1), img(y+1), img(x+1,y+1)] on the row axis turns
        # the 4 bilinear corner gathers into one (~4x fewer indices).
        # shift() clamps to edge, which matches the clip of x1i/y1i in
        # the direct 4-gather form (including uv past the high edge).
        tab = jnp.concatenate(
            [img, shift(img, 1, 0), shift(img, 0, 1), shift(img, 1, 1)],
            axis=0).reshape(4 * C, H * W)
        x0i = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, W - 1)
        y0i = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, H - 1)
        # fractions RELATIVE TO THE CLIPPED base, clamped to [0, 1]:
        # for x in (-1, 0) the unclipped fraction (x - floor(x)) would
        # blend texel 1 in with weight up to ~1 (a hard discontinuity
        # just left of u = 0.5/W), where the clamp-to-edge sampler being
        # emulated clamps BOTH corners to texel 0.  fx = clip(x - x0i)
        # reproduces that: 0 below the low edge, the plain fraction in
        # the interior, 1 past the high edge (corner row then clamps).
        fx = jnp.clip(x - x0i, 0.0, 1.0)
        fy = jnp.clip(y - y0i, 0.0, 1.0)
        c = tab[:, jax.lax.optimization_barrier(y0i * W + x0i)]
        c00, c10 = c[:C], c[C:2 * C]
        c01, c11 = c[2 * C:3 * C], c[3 * C:]
        top = c00 * (1 - fx) + c10 * fx
        bot = c01 * (1 - fx) + c11 * fx
        out = top * (1 - fy) + bot * fy
    if squeeze:
        out = out[0]
    return out


def sample_screen_separable(img, u, v):
    """Bilinear clamp-to-edge sample at the OUTER PRODUCT of 1-D u
    (length W') and 1-D v (length H') — for separable sampling grids
    (axis-aligned resamples) this is 4 small 1-D gathers instead of a
    per-pixel flat gather.

    BIT-IDENTICAL to ``sample_screen(img, meshgrid(u, v))``: the x-axis
    lerp runs first with the same clamped-fraction math, then the
    y-axis lerp — the same operation order and rounding as
    sample_screen's top/bot blend.  img: (C, H, W) or (H, W).
    """
    squeeze = img.ndim == 2
    if squeeze:
        img = img[None]
    C, H, W = img.shape
    x = u * W - 0.5
    y = v * H - 0.5
    x0i = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, W - 1)
    y0i = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, H - 1)
    x1i = jnp.clip(x0i + 1, 0, W - 1)
    y1i = jnp.clip(y0i + 1, 0, H - 1)
    fx = jnp.clip(x - x0i, 0.0, 1.0)[None, None, :]
    fy = jnp.clip(y - y0i, 0.0, 1.0)[None, :, None]
    # x lerp first (matches sample_screen's top/bot order), then y
    ax = img[:, :, x0i] * (1 - fx) + img[:, :, x1i] * fx   # (C, H, W')
    out = ax[:, y0i] * (1 - fy) + ax[:, y1i] * fy          # (C, H', W')
    return out[0] if squeeze else out


def upsample_bilinear(img, oh, ow):
    """(C, h, w) -> (C, oh, ow) bilinear — separable, gather-free for
    integer factors (uses 1-D index arithmetic on each axis)."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[None]
    C, H, W = img.shape
    ys = (jnp.arange(oh, dtype=jnp.float32) + 0.5) * H / oh - 0.5
    xs = (jnp.arange(ow, dtype=jnp.float32) + 0.5) * W / ow - 0.5
    y0 = jnp.clip(jnp.floor(ys).astype(jnp.int32), 0, H - 1)
    x0 = jnp.clip(jnp.floor(xs).astype(jnp.int32), 0, W - 1)
    y1 = jnp.clip(y0 + 1, 0, H - 1)
    x1 = jnp.clip(x0 + 1, 0, W - 1)
    fy = jnp.clip(ys - y0, 0.0, 1.0)[None, :, None]
    fx = jnp.clip(xs - x0, 0.0, 1.0)[None, None, :]
    a = img[:, y0][:, :, x0] * (1 - fx) + img[:, y0][:, :, x1] * fx
    b = img[:, y1][:, :, x0] * (1 - fx) + img[:, y1][:, :, x1] * fx
    out = a * (1 - fy) + b * fy
    return out[0] if squeeze else out


def sample_shadow_cmp(shadow, uv, ref, border: float = 1.0):
    """Comparison-sampler shadow fetch (renderer.cpp:54-69).

    shadow: (S, S) depth; uv: (2, ...); ref: (...,).  Returns (...)
    in [0,1]: bilinear blend of per-texel (ref < depth) tests;
    out-of-range texels read the opaque-white border.
    """
    S = shadow.shape[-1]
    x = uv[0] * S - 0.5
    y = uv[1] * S - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)

    flat = shadow.reshape(-1)

    def fetch(xi, yi):
        inside = (xi >= 0) & (xi < S) & (yi >= 0) & (yi < S)
        xs = jnp.clip(xi, 0, S - 1)
        ys = jnp.clip(yi, 0, S - 1)
        idx = jax.lax.optimization_barrier(ys * S + xs)
        d = jnp.where(inside, flat[idx], border)
        return (ref < d).astype(jnp.float32)

    t00 = fetch(x0i, y0i)
    t10 = fetch(x0i + 1, y0i)
    t01 = fetch(x0i, y0i + 1)
    t11 = fetch(x0i + 1, y0i + 1)
    top = t00 * (1 - fx) + t10 * fx
    bot = t01 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy
