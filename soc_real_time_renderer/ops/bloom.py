"""Bloom: CoD:AW 13-tap downsample + 3x3 tent additive upsample chain.

Port of ``bloom_downsample.inl:71-144`` / ``bloom_upsample.inl:80-130``
with the reference's graph wiring (``renderer.cpp:1024-1062``): the
chain runs on the **emissive** target — emissive -> mip0 (FULL res) ->
mip1 (half) -> ... -> mip3, then additively upsampled back
(ONE+ONE blending, ``bloom_upsample.inl:31-44``).  Mip i is
(W >> i, H >> i) (renderer.cpp:862-881).

Every tap lands on an integer/half-integer lattice, so the whole chain is shifts + 2x2 pools + a separable x2
upsample — ZERO gathers:

* downsample to half res: dst texel = 2x2 box at (2x+ox, 2y+oy); the
  13 taps share one base, so it's sum(w_k * shift(src, k)) -> avgpool2;
* same-size pass (emissive -> mip0): taps are plain integer shifts;
* upsample: the 3x3 tent filter runs at source res (shifts), then one
  separable bilinear x2 (weights 0.25/0.75 interleave).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .sampling import shift

# 13-tap weights by (ox, oy) offset in source texels
# (bloom_downsample.inl:119-141)
_DOWN_TAPS = (
    [(0, 0, 0.125)]
    + [(ox, oy, 0.03125) for ox in (-2, 2) for oy in (-2, 2)]
    + [(0, 2, 0.0625), (0, -2, 0.0625), (-2, 0, 0.0625), (2, 0, 0.0625)]
    + [(ox, oy, 0.125) for ox in (-1, 1) for oy in (-1, 1)]
)

_TENT = [(-1, -1, 1.0), (0, -1, 2.0), (1, -1, 1.0),
         (-1, 0, 2.0), (0, 0, 4.0), (1, 0, 2.0),
         (-1, 1, 1.0), (0, 1, 2.0), (1, 1, 1.0)]


def _filter13(src):
    out = jnp.zeros_like(src)
    for ox, oy, w in _DOWN_TAPS:
        out = out + w * shift(src, ox, oy)
    return out


def _avgpool2(img):
    C, H, W = img.shape
    return img[:, :H // 2 * 2, :W // 2 * 2].reshape(
        C, H // 2, 2, W // 2, 2).mean(axis=(2, 4))


def downsample_13tap(src, dst_h, dst_w):
    """(3, H, W) -> (3, dst_h, dst_w), dst = src or src/2."""
    H, W = src.shape[1:]
    if (dst_h, dst_w) == (H, W):
        return _filter13(src)
    assert (dst_h, dst_w) == (H // 2, W // 2), (src.shape, dst_h, dst_w)
    # dst texel centre sits at src (2x+0.5, 2y+0.5): each tap is a 2x2
    # box of the tap-shifted source
    out = jnp.zeros((src.shape[0], dst_h, dst_w), src.dtype)
    for ox, oy, w in _DOWN_TAPS:
        out = out + w * _avgpool2(shift(src, ox, oy))
    return out


def _upsample2(img):
    """Separable bilinear x2: out length 2N, weights 0.75/0.25."""
    def axis_up(x, axis):
        a = shift(x, -1, 0) if axis == 2 else shift(x, 0, -1)
        b = shift(x, 1, 0) if axis == 2 else shift(x, 0, 1)
        even = 0.25 * a + 0.75 * x
        odd = 0.75 * x + 0.25 * b
        stacked = jnp.stack([even, odd], axis=axis + 1)
        shp = list(x.shape)
        shp[axis] *= 2
        return stacked.reshape(shp)

    return axis_up(axis_up(img, 2), 1)


def _up2_to(t, dst_h, dst_w):
    """x2 upsample fitted to (dst_h, dst_w).

    Mip chains floor-divide (h_i = H >> i), so the destination of an
    upsample is 2*src or 2*src + 1 per axis; an odd destination's last
    row/col replicates the edge (the clamp-to-edge sampler's boundary
    behaviour).  Slicing alone left the odd case one short and the
    mip add failed to trace (review r3)."""
    up = _upsample2(t)
    ph = dst_h - up.shape[1]
    pw = dst_w - up.shape[2]
    assert -1 <= ph <= 1 and -1 <= pw <= 1, (t.shape, dst_h, dst_w)
    if ph > 0 or pw > 0:
        up = _edge_pad(up, 0, max(ph, 0), 0, max(pw, 0))
    return up[:, :dst_h, :dst_w]


def upsample_tent(src, dst_h, dst_w):
    """(3, h, w) lower mip -> (3, dst_h, dst_w) tent-filtered
    (tap offsets are in SOURCE texel units, upsample.inl:99-100)."""
    t = jnp.zeros_like(src)
    for ox, oy, w in _TENT:
        t = t + w * shift(src, ox, oy)
    t = t / 16.0
    if (dst_h, dst_w) == src.shape[1:]:
        return t
    return _up2_to(t, dst_h, dst_w)


def bloom_shifts(emissive, mip_count: int = 4):
    """Shift-chain implementation (kept as the conv path's test
    oracle)."""
    H, W = emissive.shape[1:]
    mips = []
    cur = emissive
    for i in range(mip_count):
        h, w = max(H >> i, 1), max(W >> i, 1)
        cur = downsample_13tap(cur, h, w)
        mips.append(cur)
    cur = mips[-1]
    for i in range(mip_count - 2, -1, -1):
        h, w = mips[i].shape[1:]
        cur = mips[i] + upsample_tent(cur, h, w)
    return emissive + upsample_tent(cur, H, W)


# ---------------------------------------------------------------------------
# Depthwise-convolution implementation (the fast path): the shift-chain
# version materializes 13 shifted copies per level (~39 ms/frame at
# 720p); a single depthwise conv runs the same filter in one pass.
# Edge handling matches the clamp-to-edge samplers via edge padding.
# ---------------------------------------------------------------------------


def _edge_pad(img, lo_y, hi_y, lo_x, hi_x):
    return jnp.pad(img, ((0, 0), (lo_y, hi_y), (lo_x, hi_x)), mode="edge")


def _depthwise(img, kernel):
    """img: (C, H', W') pre-padded; kernel: (kh, kw) -> VALID conv."""
    C = img.shape[0]
    k = jnp.asarray(kernel, jnp.float32)
    k = jnp.broadcast_to(k[None, None], (C, 1) + k.shape)
    out = jax.lax.conv_general_dilated(
        img[None], k, window_strides=(1, 1), padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"), feature_group_count=C)
    return out[0]


def _kernel_13tap():
    k = np.zeros((5, 5), np.float32)
    for ox, oy, w in _DOWN_TAPS:
        k[oy + 2, ox + 2] += w
    return k


def _kernel_13tap_down():
    """13-tap ⊗ 2x2 box: the stride-2 downsample kernel (6x6).

    dst(x) = Σ_k w_k/4 Σ_{a,b∈{0,1}} src[2x + o_k + a]."""
    k5 = _kernel_13tap()
    k6 = np.zeros((6, 6), np.float32)
    for a in range(2):
        for b in range(2):
            k6[a:a + 5, b:b + 5] += k5 * 0.25
    return k6


def _kernel_tent():
    k = np.zeros((3, 3), np.float32)
    for ox, oy, w in _TENT:
        k[oy + 1, ox + 1] += w / 16.0
    return k


def downsample_13tap_conv(src, dst_h, dst_w):
    H, W = src.shape[1:]
    if (dst_h, dst_w) == (H, W):
        return _depthwise(_edge_pad(src, 2, 2, 2, 2), _kernel_13tap())
    p = _edge_pad(src, 2, 3, 2, 3)
    C = src.shape[0]
    k = jnp.asarray(_kernel_13tap_down(), jnp.float32)
    k = jnp.broadcast_to(k[None, None], (C, 1, 6, 6))
    out = jax.lax.conv_general_dilated(
        p[None], k, window_strides=(2, 2), padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"), feature_group_count=C)
    return out[0, :, :dst_h, :dst_w]


def upsample_tent_conv(src, dst_h, dst_w):
    t = _depthwise(_edge_pad(src, 1, 1, 1, 1), _kernel_tent())
    if (dst_h, dst_w) == src.shape[1:]:
        return t
    return _up2_to(t, dst_h, dst_w)


def bloom_depthwise(emissive, mip_count: int = 4):
    """Depthwise-conv chain (superseded by the matmul path below; kept as
    a second oracle — it runs the filters on the VPU, ~12 ms at
    1080p)."""
    H, W = emissive.shape[1:]
    mips = []
    cur = emissive
    for i in range(mip_count):
        h, w = max(H >> i, 1), max(W >> i, 1)
        cur = downsample_13tap_conv(cur, h, w)
        mips.append(cur)
    cur = mips[-1]
    for i in range(mip_count - 2, -1, -1):
        h, w = mips[i].shape[1:]
        cur = mips[i] + upsample_tent_conv(cur, h, w)
    return emissive + upsample_tent_conv(cur, H, W)


# ---------------------------------------------------------------------------
# Matmul implementation (the production path): each 2-D filter is
# SVD-split into separable rank-1 terms (the tent is exactly rank 1, the
# 13-tap is rank 3), and each 1-D pass is a banded-matrix product
# (C*H, W') @ (W', W).
# ---------------------------------------------------------------------------


# The banded products run at DEFAULT precision (TF32 on the GPU): on an
# H100 the full 1920x1088 chain differs from HIGHEST by at most 3.1e-3
# on a peak of 7.9 (4e-4 relative), a blur-weight error far below what
# reaches the tonemapped frame, while HIGHEST takes 2.4x the time
# (PERF.md, PR 1; tools/kernel_times.py measures both).
MATMUL_PRECISION = jax.lax.Precision.DEFAULT


def _band_matrix(n_in, n_out, taps, stride: int = 1):
    """(n_in, n_out) f32: B[i, o] = taps[i - stride*o] (valid conv)."""
    ii = jnp.arange(n_in, dtype=jnp.int32)[:, None]
    oo = jnp.arange(n_out, dtype=jnp.int32)[None, :]
    d = ii - stride * oo
    b = jnp.zeros((n_in, n_out), jnp.float32)
    for k, w in enumerate(taps):
        if w != 0.0:
            b = b + jnp.where(d == k, jnp.float32(w), 0.0)
    return b


def _conv_sep_mxu(img, kernel, stride: int = 1, pad=None):
    """Edge-padded 2-D correlation of (C, H, W) with `kernel` via
    SVD-separable banded matmuls (f32 accumulate).
    kernel must be a STATIC numpy array (SVD happens at trace time)."""
    kh, kw = kernel.shape
    if pad is None:
        pad = (kh // 2, kh - 1 - kh // 2, kw // 2, kw - 1 - kw // 2)
    u, s, vt = np.linalg.svd(kernel)
    terms = [(u[:, i] * s[i], vt[i]) for i in range(len(s))
             if s[i] > 1e-7 * s[0]]
    p = _edge_pad(img, *pad)
    C, Hp, Wp = p.shape
    H_out = (Hp - kh) // stride + 1
    W_out = (Wp - kw) // stride + 1
    out = None
    prec = MATMUL_PRECISION
    for ky, kx in terms:
        bx = _band_matrix(Wp, W_out, kx, stride)
        by = _band_matrix(Hp, H_out, ky, stride)
        t = jnp.einsum("chw,wx->chx", p, bx, precision=prec,
                       preferred_element_type=jnp.float32)
        t = jnp.einsum("chx,hy->cyx", t, by, precision=prec,
                       preferred_element_type=jnp.float32)
        out = t if out is None else out + t
    return out


def bloom(emissive, mip_count: int = 4):
    """Full chain on the emissive target (separable banded-matmul path);
    additive upsample back into each level (ONE+ONE) and finally into
    emissive."""
    H, W = emissive.shape[1:]
    mips = []
    cur = emissive
    for i in range(mip_count):
        h, w = max(H >> i, 1), max(W >> i, 1)
        if (h, w) == cur.shape[1:]:
            cur = _conv_sep_mxu(cur, _kernel_13tap())
        else:
            cur = _conv_sep_mxu(cur, _kernel_13tap_down(),
                                stride=2, pad=(2, 3, 2, 3))[:, :h, :w]
        mips.append(cur)
    cur = mips[-1]
    for i in range(mip_count - 2, -1, -1):
        h, w = mips[i].shape[1:]
        cur = mips[i] + _up_tent_mxu(cur, h, w)
    return emissive + _up_tent_mxu(cur, H, W)


def _up_tent_mxu(src, dst_h, dst_w):
    t = _conv_sep_mxu(src, _kernel_tent())
    if (dst_h, dst_w) == src.shape[1:]:
        return t
    return _up2_to(t, dst_h, dst_w)
