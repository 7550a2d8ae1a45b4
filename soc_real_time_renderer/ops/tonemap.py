"""AgX_DS tone mapping.

Port of the reference's tone-mapping pass
(``/root/reference/src/graphics/tasks/tone_mapping.inl:74-179``), the
AgX "dual section" variant: sRGB -> gamut-compressed working space ->
dual-section curve -> saturation mix -> inverse transform, with exposure
applied as ``2^exposure`` from the auto-exposure state.

Reference quirk kept: the combined matrix is built as
``sRGB_to_XYZ * XYZ_to_adjusted`` (``:160``), which applies the
XYZ->adjusted matrix to an sRGB vector first — mathematically odd but
exactly what the shader computes.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_XY_RED = (0.64, 0.33)
_XY_GREEN = (0.3, 0.6)
_XY_BLUE = (0.15, 0.06)
_XY_WHITE = (0.3127, 0.3290)


def _unproject(xy):
    x, y = xy
    return jnp.array([x / y, 1.0, (1.0 - x - y) / y], jnp.float32)


def _mm(a, b):
    """3x3 colour-matrix products at HIGHEST precision (no TF32)."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def _apply3(m, flat):
    """(3, 3) matrix times (3, P) pixels as an exact elementwise form."""
    return jnp.stack([m[i, 0] * flat[0] + m[i, 1] * flat[1]
                      + m[i, 2] * flat[2] for i in range(3)])


def _primaries_to_matrix(xy_r, xy_g, xy_b, xy_w):
    """tone_mapping.inl:103-116 (columns are primaries)."""
    r, gq, b, w = (_unproject(v) for v in (xy_r, xy_g, xy_b, xy_w))
    temp = jnp.stack([
        jnp.array([r[0], gq[0], b[0]]),
        jnp.array([1.0, 1.0, 1.0]),
        jnp.array([r[2], gq[2], b[2]])], axis=0)
    scale = _mm(jnp.linalg.inv(temp), w)
    return jnp.stack([r * scale[0], gq * scale[1], b * scale[2]], axis=1)


def _compression_matrix(compression):
    """tone_mapping.inl:118-127."""
    s = 1.0 / (1.0 - compression)
    w = jnp.array(_XY_WHITE, jnp.float32)

    def mixw(p):
        p = jnp.array(p, jnp.float32)
        return w + (p - w) * s

    r, g, b = mixw(_XY_RED), mixw(_XY_GREEN), mixw(_XY_BLUE)
    ru, gu, bu = (_unproject_dyn(v) for v in (r, g, b))
    return _primaries_to_matrix_dyn(ru, gu, bu, _unproject(_XY_WHITE))


def _unproject_dyn(xy):
    return jnp.stack([xy[0] / xy[1], jnp.float32(1.0),
                      (1.0 - xy[0] - xy[1]) / xy[1]])


def _primaries_to_matrix_dyn(r, g, b, w):
    temp = jnp.stack([
        jnp.stack([r[0], g[0], b[0]]),
        jnp.ones(3, jnp.float32),
        jnp.stack([r[2], g[2], b[2]])], axis=0)
    scale = _mm(jnp.linalg.inv(temp), w)
    return jnp.stack([r * scale[0], g * scale[1], b * scale[2]], axis=1)


def _dual_section(x, linear, peak):
    """tone_mapping.inl:129-137."""
    S = peak * linear
    C = peak / jnp.maximum(peak - S, 1e-6)
    shoulder = peak - (peak - S) * jnp.exp((-C * (x - S)) / peak)
    return jnp.where(x < S, x, shoulder)


def agx_ds(color, exposure, saturation, linear_section, peak, compression):
    """color: (3, H, W) linear HDR -> (3, H, W) display-referred [0,1].

    Args are scalars (traced): tone_mapping.inl:146-170.
    """
    work = jnp.maximum(color, 0.0) * jnp.exp2(exposure)

    srgb_to_xyz = _primaries_to_matrix(_XY_RED, _XY_GREEN, _XY_BLUE,
                                       _XY_WHITE)
    adjusted_to_xyz = _compression_matrix(compression)
    xyz_to_adjusted = jnp.linalg.inv(adjusted_to_xyz)
    # Reference order quirk (:160): sRGB_to_XYZ * XYZ_to_adjusted.
    srgb_to_adjusted = _mm(srgb_to_xyz, xyz_to_adjusted)

    flat = _apply3(srgb_to_adjusted, work.reshape(3, -1))
    flat = jnp.clip(_dual_section(flat, linear_section, peak), 0.0, 1.0)
    lum_w = (0.2126729, 0.7151522, 0.0721750)
    lum = lum_w[0] * flat[0] + lum_w[1] * flat[1] + lum_w[2] * flat[2]
    flat = lum[None, :] + (flat - lum[None, :]) * saturation
    flat = jnp.clip(flat, 0.0, 1.0)
    flat = _apply3(jnp.linalg.inv(srgb_to_adjusted), flat)
    return flat.reshape(color.shape)


def tone_map(color, exposure, g):
    """Apply AgX_DS with the ShaderGlobals tonemap params
    (tone_mapping.inl:173-177)."""
    return agx_ds(color, exposure, g.saturation, g.agx_ds_linear_section,
                  g.peak, g.compression)
