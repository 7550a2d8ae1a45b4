"""Screen-space reflections (planar).

Port of ``screen_space_reflection.inl:74-186``: view-space ray march
(50 iterations, exponential step x1.05, adaptive direction) followed by
binary-search refinement using the *remaining* iteration budget; hit
when |delta| < 0.05.  Non-metallic pixels (metallic < 0.01) pass the
albedo through (``:175-178``); MISSES output black — the shader's
albedo fallback at ``:184-186`` is dead code, since ``out_ssr``'s alpha
is written 1.0 at ``:183`` and ``out_ssr == vec4(0.0)`` can never hold.

Reference quirks: the march compares |view z|; the declared min/max HiZ
inputs are never read by the shader (``:17-18``) — same here (the
pyramids themselves live in ops/hiz.py); the result is computed but NOT
composited by default (composition.inl:213-216 commented out) —
RenderConfig.composite_ssr.

The divergent loop (early return / break / phase switch) becomes a
masked lax.fori_loop state machine.  The march is 50 *dependent*
screen-space gathers per pixel, so it runs on the COMPACTED set of
reflective pixels (``ssr(..., compact_cap=N)``)
— the exact analog of the reference's early return at ``:175-178``,
where warps whose lanes are all non-metallic never execute the march
at all.  Cost then scales with actual reflective pixels instead of the
full screen (sponza is mostly dielectric).  Output is IDENTICAL to the
dense march: each ray depends only on its own pixel's inputs, and the
compaction is capped + overflow-flagged (OVERFLOW_SSR_CAP).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from . import sampling
from .composition import view_from_depth
from ..utils.vec import dot3, normalize3

RAY_STEP = 0.5
ITERATIONS = 50
DISTANCE_BIAS = 0.05
METALLIC_MIN = 0.01      # early-out threshold (inl:175-178)

OVERFLOW_SSR_CAP = 16    # FrameOutputs.overflow bit: reflective pixels
#                          exceeded FramePlan.ssr_cap (dropped rays
#                          output black, never garbage)


def _march(pos, n_view, depth, g):
    """The 50-iteration state machine on ray bundles of any trailing
    shape: pos/n_view (3, ...), depth the full (H, W) screen.  Returns
    (found (...), hit_uv (2, ...))."""
    refl = normalize3(pos - 2.0 * dot3(pos, n_view)[None] * n_view)
    proj = g.camera.projection
    inv_p = g.camera.inv_projection
    tail = pos.shape[1:]

    def project_uv(p):
        x = proj[0, 0] * p[0] + proj[0, 1] * p[1] + proj[0, 2] * p[2] + proj[0, 3]
        y = proj[1, 0] * p[0] + proj[1, 1] * p[1] + proj[1, 2] * p[2] + proj[1, 3]
        w = proj[3, 0] * p[0] + proj[3, 1] * p[1] + proj[3, 2] * p[2] + proj[3, 3]
        ws = jnp.where(w != 0, w, 1.0)
        return jnp.stack([x / ws * 0.5 + 0.5, y / ws * 0.5 + 0.5])

    def probe(p):
        spos = project_uv(p)
        sd = sampling.sample_screen(depth, spos)
        vz = view_from_depth(spos, sd, inv_p)[2]
        delta = jnp.abs(p[2]) - jnp.abs(vz)
        return spos, delta

    step0 = refl * RAY_STEP
    march0 = pos + step0

    def body(i, st):
        step, mpos, phase, found, hit_uv = st
        spos, delta = probe(mpos)
        hit = (jnp.abs(delta) < DISTANCE_BIAS) & ~found
        found_n = found | hit
        hit_uv = jnp.where(hit[None], spos, hit_uv)

        marching = (phase == 0) & ~found_n
        to_binary = marching & (delta > 0)
        phase_n = jnp.where(to_binary, 1, phase)
        dsign = jnp.sign(delta)
        m_step = step * (1.0 - RAY_STEP * jnp.maximum(dsign, 0.0))[None]
        m_pos = mpos + m_step * (-dsign)[None]
        m_step = m_step * 1.05

        b_step = step * 0.5
        b_pos = mpos - b_step * jnp.sign(delta)[None]

        binary = (phase_n == 1) & ~found_n
        advance = marching & ~to_binary
        step_n = jnp.where(advance[None], m_step,
                           jnp.where(binary[None], b_step, step))
        mpos_n = jnp.where(advance[None], m_pos,
                           jnp.where(binary[None], b_pos, mpos))
        return (step_n, mpos_n, phase_n, found_n, hit_uv)

    init = (step0, march0,
            jnp.zeros(tail, jnp.int32), jnp.zeros(tail, bool),
            jnp.zeros((2,) + tail, jnp.float32))
    _, _, _, found, hit_uv = lax.fori_loop(0, ITERATIONS, body, init)
    return found, hit_uv


def ssr(depth, albedo, normal, metallic_roughness, g,
        compact_cap: int = 0):
    """depth: (H, W); albedo/normal: (3, H, W); metallic_roughness:
    (2, H, W) (R=rough, G=metal).  Returns ((3, H, W), overflow ()
    int32, n_active () int32).

    compact_cap > 0: march only the compacted reflective pixels
    (metallic >= 0.01), up to `compact_cap` of them — see module
    docstring.  n_active is the true reflective-pixel count this frame
    (sizes the cap from data, the tex_dirty pattern); overflow carries
    OVERFLOW_SSR_CAP when it exceeded the cap (over-cap rays output
    black).  compact_cap == 0: dense march of every pixel (identical
    output, reference-shaped cost).
    """
    H, W = depth.shape
    uv = sampling.grid_uv(H, W)
    vm = g.camera.view[:3, :3]
    metallic = metallic_roughness[1]

    def view_normal(nrm):
        return normalize3(jnp.stack([
            vm[0, 0] * nrm[0] + vm[0, 1] * nrm[1] + vm[0, 2] * nrm[2],
            vm[1, 0] * nrm[0] + vm[1, 1] * nrm[1] + vm[1, 2] * nrm[2],
            vm[2, 0] * nrm[0] + vm[2, 1] * nrm[1] + vm[2, 2] * nrm[2]]))

    if compact_cap <= 0:
        pos = view_from_depth(uv, depth, g.camera.inv_projection)
        found, hit_uv = _march(pos, view_normal(normal), depth, g)
        hit_color = sampling.sample_screen(albedo, hit_uv)    # (3, H, W)
        out = jnp.where(found[None], hit_color, 0.0)
        out = jnp.where((metallic < METALLIC_MIN)[None], albedo, out)
        return out, jnp.int32(0), jnp.int32(-1)

    P = H * W
    active = (metallic >= METALLIC_MIN).reshape(-1)
    n_active = jnp.sum(active.astype(jnp.int32))
    overflow = jnp.where(n_active > compact_cap,
                         OVERFLOW_SSR_CAP, 0).astype(jnp.int32)
    idx = jnp.nonzero(active, size=compact_cap, fill_value=P)[0]
    # unused slots march DISTINCT addresses (all-identical gather
    # indices serialize on one memory location), so fillers spread
    # across the screen; their
    # results are never scattered back (their scatter index stays P =
    # dropped), so colliding with a real pixel is harmless.
    filler = (jnp.arange(compact_cap, dtype=jnp.int32) * 7919) % P
    gidx = jax.lax.optimization_barrier(jnp.where(idx < P, idx, filler))

    uvf = uv.reshape(2, P)[:, gidx]
    df = depth.reshape(-1)[gidx]
    nf = normal.reshape(3, P)[:, gidx]
    pos = view_from_depth(uvf, df, g.camera.inv_projection)
    found, hit_uv = _march(pos, view_normal(nf), depth, g)

    hit_color = sampling.sample_screen(albedo, hit_uv)        # (3, cap)
    res = jnp.where(found[None], hit_color, 0.0)
    base = jnp.where((metallic < METALLIC_MIN)[None], albedo, 0.0)
    out = base.reshape(3, P).at[:, idx].set(res, mode="drop").reshape(
        3, H, W)
    return out, overflow, n_active
