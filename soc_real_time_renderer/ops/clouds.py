"""Volumetric clouds + single-scattering atmosphere (sky pass).

Port of ``/root/reference/src/graphics/tasks/cloud_rendering.inl``
(57-483), computed for sky pixels (depth == 1) at half resolution:

* atmosphere: 16 primary x 8 secondary steps of Rayleigh+Mie single
  scattering (``:353-439``);
* clouds: 24-step march between earth-shell intersections (``rsi``,
  ``:97-106, 314-318``), density from 4-octave fBm over a tiled 2D
  noise texture faking 3D by z-slice interpolation (``:219-233``),
  height-shaped threshold (``:235-262``), 10-step sun-visibility march,
  two-lobe HG phase, powder/Beer terms, scatter integral;
* bayer16 dithered march start; cloud drift with elapsed time;
* horizon darkening ``max(min(|sx|,|sz|) + sy, 0)`` (``:477``).

Reference quirks kept: the atmosphere's primary-ray start time is
initialised with ``globals.elapsed_time`` (``:368`` — a bug that slowly
shifts the sky over time), and the ray uv uses ``pixel/(res-1)``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

CLOUD_SPEED = 0.02
CLOUD_HEIGHT = 1600.0
CLOUD_THICKNESS = 500.0
CLOUD_DENSITY = 0.03
EARTH_RADIUS = 6371000.0
SUN_BRIGHTNESS = 3.0
CLOUD_MIN = CLOUD_HEIGHT
CLOUD_MAX = CLOUD_HEIGHT + CLOUD_THICKNESS
# numpy (not jnp) module constants: a lazy first import under a trace
# would otherwise bake TRACERS into module state (UnexpectedTracerError)
RAYLEIGH = np.array([0.27e-5, 0.5e-5, 1.0e-5], np.float32)
MIE = np.array([0.5e-6, 0.5e-6, 0.5e-6], np.float32)
TOTAL = RAYLEIGH + MIE
R_LOG2 = float(1.0 / np.log(2.0))


def _bayer2(a):
    a = jnp.floor(a)
    return jnp.mod(a[..., 0] * 0.5 + a[..., 1] * a[..., 1] * 0.75, 1.0)


def bayer16(a):
    """cloud_rendering.inl:92-113 macro expansion:
    bayer4(a)=bayer2(a/2)*0.25+bayer2(a); bayer8/16 nest the same way
    (note the macros add bayer2(a), not bayer4/8(a) — kept verbatim)."""
    def b4(x):
        return _bayer2(x * 0.5) * 0.25 + _bayer2(x)

    def b8(x):
        return b4(x * 0.5) * 0.25 + _bayer2(x)

    return b8(a * 0.5) * 0.25 + _bayer2(a)


def _rsi(position, direction, radius):
    """Ray-sphere intersection (:97-106); returns (near, far), -1 on miss."""
    pod = jnp.sum(position * direction, -1)
    delta = pod * pod + radius * radius - jnp.sum(position * position, -1)
    ok = delta >= 0
    sq = jnp.sqrt(jnp.maximum(delta, 0.0))
    near = -pod - sq
    far = -pod + sq
    return (jnp.where(ok, near, -1.0), jnp.where(ok, far, -1.0))


def _particle_thickness(depth):
    depth = depth * 2.0
    depth = jnp.maximum(depth + 0.01, 0.01)
    return 100000.0 / depth


def _particle_thickness_const(depth):
    return 100000.0 / jnp.maximum(depth * 2.0 - 0.01, 0.01)


def _absorb(coeff, depth):
    return jnp.exp(coeff * (-depth))


def _hg(x, g):
    g2 = g * g
    return 0.25 * (1.0 - g2) * (1.0 + g2 - 2.0 * g * x) ** -1.5


def _phase_two_lobes(x):
    m, gm = 0.5, 0.8
    lobe1 = _hg(x, 0.8 * gm)
    lobe2 = _hg(x, -0.5 * gm)
    return lobe2 + (lobe1 - lobe2) * m


def _powder(od):
    return 1.0 - jnp.exp(-od * 2.0)


def _scatter_integral(od, coeff=1.11):
    a = -coeff * R_LOG2
    return jnp.exp(a * od) * (-1.0 / coeff) + 1.0 / coeff


def _d02(x):
    return jnp.abs(x) + 1e-3


def _atmospheric_scattering_top(sun_dir):
    """:196-218 — constant per frame (sky light for cloud shading)."""
    ldotu = sun_dir[1]
    od = _particle_thickness_const(1.0)
    odl = _particle_thickness(ldotu)
    scatter_view = TOTAL * od
    absorb_view = _absorb(TOTAL, od)
    scatter_light = TOTAL * odl
    absorb_light = _absorb(TOTAL, odl)
    absorb_sun = _d02(absorb_light - absorb_view) / _d02(
        (scatter_light - scatter_view) * jnp.log(2.0))
    scatter_sun = MIE * od * 0.25 + RAYLEIGH * od * 0.375
    return scatter_sun * absorb_sun * SUN_BRIGHTNESS


def _hash2(x, y):
    """Procedural 2D value hash in [0, 1) of integer lattice coords
    (given as floats): an integer mixing hash, bit-exact on every
    backend.  The GLSL-style fract(sin(.) * 43758.5453) hash is not:
    the noise lattice reaches ~1e5, where each backend's sin() range
    reduction differs in the last bits and the hash turns that into a
    different cloud field (measured card vs CPU, PERF.md)."""
    def u32(v):
        return v.astype(jnp.int32).astype(jnp.uint32)

    h = u32(x) * jnp.uint32(0x27D4EB2D) ^ u32(y) * jnp.uint32(0x165667B1)
    h = (h ^ (h >> 15)) * jnp.uint32(0x2C1B3C6D)
    h = (h ^ (h >> 12)) * jnp.uint32(0x297A2D39)
    h = h ^ (h >> 15)
    return (h >> 8).astype(jnp.float32) * (1.0 / 16777216.0)


def _value_noise2(u, v):
    """Bilinear value noise over the integer lattice — pure ALU."""
    iu = jnp.floor(u)
    iv = jnp.floor(v)
    fu = u - iu
    fv = v - iv
    fu = fu * fu * (3.0 - 2.0 * fu)
    fv = fv * fv * (3.0 - 2.0 * fv)
    a = _hash2(iu, iv)
    b = _hash2(iu + 1.0, iv)
    c = _hash2(iu, iv + 1.0)
    d = _hash2(iu + 1.0, iv + 1.0)
    return (a + (b - a) * fu) * (1 - fv) + (c + (d - c) * fu) * fv


def _get_3d_noise(pos, noise_tex):
    """:219-233: fake 3D from a tiled 2D noise field with z-slice
    interpolation.  With noise_tex=None the reference's noise.png is
    replaced by procedural value noise (gather-free; cloud shapes
    differ from the reference but statistics match)."""
    p = jnp.floor(pos[..., 2])
    f = pos[..., 2] - p
    inv_res = 1.0 / 64.0
    z_stretch = 17.0 * inv_res
    cu = pos[..., 0] * inv_res + p * z_stretch
    cv = pos[..., 1] * inv_res + p * z_stretch
    if noise_tex is None:
        n0 = _value_noise2(cu * 64.0, cv * 64.0)
        n1 = _value_noise2((cu + z_stretch) * 64.0, (cv + z_stretch) * 64.0)
    else:
        n0 = _sample_repeat(noise_tex, jnp.stack([cu, cv], -1))
        n1 = _sample_repeat(noise_tex,
                            jnp.stack([cu + z_stretch, cv + z_stretch], -1))
    return n0 + (n1 - n0) * f


def _sample_repeat(tex, uv):
    """Bilinear repeat sampling of (N, N) float texture."""
    N = tex.shape[-1]
    x = uv[..., 0] * N - 0.5
    y = uv[..., 1] * N - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = jnp.remainder(x0.astype(jnp.int32), N)
    x1i = jnp.remainder(x0i + 1, N)
    y0i = jnp.remainder(y0.astype(jnp.int32), N)
    y1i = jnp.remainder(y0i + 1, N)
    flat = tex.reshape(-1)
    c00 = flat[y0i * N + x0i]
    c10 = flat[y0i * N + x1i]
    c01 = flat[y1i * N + x0i]
    c11 = flat[y1i * N + x1i]
    return ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
            + (c01 * (1 - fx) + c11 * fx) * fy)


def _get_clouds(p, camera_pos, elapsed_time, noise_tex):
    """:235-262."""
    up = jnp.array([0.0, EARTH_RADIUS, 0.0], jnp.float32)
    py = jnp.linalg.norm(p + up, axis=-1) - EARTH_RADIUS
    pxz = p[..., ::2] + camera_pos[::2]
    inside = (py >= CLOUD_MIN) & (py <= CLOUD_MAX)

    time = -CLOUD_SPEED * elapsed_time
    mv = jnp.stack([time, jnp.zeros_like(time), time], -1)
    coord = jnp.stack([pxz[..., 0], py, pxz[..., 1]], -1) * 0.001 + mv

    def n3(c):
        return _get_3d_noise(c, noise_tex)

    noise = n3(coord) * 0.5
    noise += n3(coord * 2.0 + mv) * 0.25
    noise += n3(coord * 7.0 - mv) * 0.125
    noise += n3((coord + mv) * 16.0) * 0.0625

    hh = py - CLOUD_MIN
    thresh = (1.0 - jnp.exp(-0.01 * hh)) * jnp.exp(-0.004 * hh)
    t = jnp.clip((noise - 0.55) / 0.05, 0.0, 1.0)
    clouds = (t * t * (3.0 - 2.0 * t)) * thresh
    return jnp.where(inside, clouds * CLOUD_DENSITY, 0.0)


def _sun_visibility(p, sun_dir, camera_pos, elapsed_time, noise_tex,
                    steps: int = 10):
    """:264-278 (fori_loop; a batched leading-axis march was MEASURED
    SLOWER — 13.5 vs 9.5 ms for the sky LUT — because the (..., 3)
    vectors-last layout waste grows with the batch axis)."""
    from jax import lax
    r_steps = CLOUD_THICKNESS / steps
    inc = sun_dir * r_steps
    p0 = p + inc * 0.5

    def body(i, trans):
        pos = p0 + inc * i.astype(jnp.float32)
        return trans + _get_clouds(pos, camera_pos, elapsed_time, noise_tex)

    trans = lax.fori_loop(0, steps, body,
                          jnp.zeros(p.shape[:-1], jnp.float32))
    return jnp.exp(-trans * r_steps)


def _volumetric_clouds(ray_dir, sun_dir, color, dither, sun_color,
                       camera_pos, elapsed_time, noise_tex,
                       steps: int = 24):
    """:307-350."""
    up = jnp.array([0.0, 1.0, 0.0], jnp.float32) * EARTH_RADIUS
    _, bottom = _rsi(up, ray_dir, EARTH_RADIUS + CLOUD_MIN)
    _, top = _rsi(up, ray_dir, EARTH_RADIUS + CLOUD_MAX)
    start = ray_dir * bottom[..., None]
    end = ray_dir * top[..., None]
    inc = (end - start) / steps
    pos = start + inc * dither[..., None]
    step_len = jnp.linalg.norm(inc, axis=-1)

    ldotw = jnp.sum(ray_dir * sun_dir, -1)
    phase = _phase_two_lobes(ldotw)
    sky_light = _atmospheric_scattering_top(sun_dir)

    from jax import lax

    def body(i, carry):
        scattering, trans = carry
        cpos = pos + inc * i.astype(jnp.float32)
        od = _get_clouds(cpos, camera_pos, elapsed_time, noise_tex) * step_len
        sunv = _sun_visibility(cpos, sun_dir, camera_pos, elapsed_time,
                               noise_tex)
        integral = _scatter_integral(od)
        beers_powder = _powder(od * jnp.log(2.0))
        sunlight = (sun_color * (sunv * beers_powder * phase)[..., None]
                    * (0.5 * jnp.pi) * SUN_BRIGHTNESS)
        skylight = sky_light * 0.25 / jnp.pi
        scat = (sunlight + skylight) * (integral * jnp.pi)[..., None]
        hit = od > 0.0
        scattering = scattering + jnp.where(
            hit[..., None], scat * trans[..., None], 0.0)
        trans = jnp.where(hit, trans * jnp.exp(-od), trans)
        return scattering, trans

    scattering, trans = lax.fori_loop(
        0, steps, body, (jnp.zeros(color.shape, jnp.float32),
                         jnp.ones(step_len.shape, jnp.float32)))

    mixed = color * trans[..., None] + scattering
    fade = jnp.clip(jnp.linalg.norm(start, axis=-1) * 0.00001 * 2.5, 0.0, 1.0)
    out = mixed + (color - mixed) * fade[..., None]
    return jnp.where((ray_dir[..., 1] < 0.0)[..., None], color, out)


def _atmosphere(ray_dir, origin, sun_dir, elapsed_time,
                i_sun=22.0, r_planet=6371e3, r_atmos=6471e3,
                sh_rlh=8e3, sh_mie=1.2e3, g=0.758,
                i_steps: int = 16, j_steps: int = 8):
    """:355-439 (nvnv's 'atmosphere' with the iTime=elapsed_time quirk)."""
    k_rlh = jnp.array([5.5e-6, 13.0e-6, 22.4e-6], jnp.float32)
    k_mie = 21e-6
    r = ray_dir / jnp.maximum(
        jnp.linalg.norm(ray_dir, axis=-1, keepdims=True), 1e-12)
    p_near, p_far = _rsi(origin, r, r_atmos)
    miss = p_near > p_far
    g_near, _ = _rsi(origin, r, r_planet)
    p_far = jnp.minimum(p_far, g_near)
    i_step = (p_far - p_near) / i_steps

    mu = jnp.sum(r * sun_dir, -1)
    mumu = mu * mu
    gg = g * g
    p_rlh = 3.0 / (16.0 * jnp.pi) * (1.0 + mumu)
    p_mie = (3.0 / (8.0 * jnp.pi) * ((1.0 - gg) * (mumu + 1.0))
             / ((1.0 + gg - 2.0 * mu * g) ** 1.5 * (2.0 + gg)))

    i_time = jnp.broadcast_to(elapsed_time, i_step.shape)  # the :368 quirk
    total_rlh = jnp.zeros(r.shape, jnp.float32)
    total_mie = jnp.zeros(r.shape, jnp.float32)
    i_od_rlh = jnp.zeros(i_step.shape, jnp.float32)
    i_od_mie = jnp.zeros(i_step.shape, jnp.float32)

    from jax import lax

    def i_body(ii, carry):
        (i_time, total_rlh, total_mie, i_od_rlh, i_od_mie) = carry
        i_pos = origin + r * (i_time + i_step * 0.5)[..., None]
        i_h = jnp.linalg.norm(i_pos, axis=-1) - r_planet
        od_rlh = jnp.exp(-i_h / sh_rlh) * i_step
        od_mie = jnp.exp(-i_h / sh_mie) * i_step
        i_od_rlh = i_od_rlh + od_rlh
        i_od_mie = i_od_mie + od_mie

        _, j_far = _rsi(i_pos, sun_dir, r_atmos)
        j_step = j_far / j_steps

        def j_body(jj, jcarry):
            j_od_rlh, j_od_mie = jcarry
            j_time = j_step * jj.astype(jnp.float32)
            j_pos = i_pos + sun_dir * (j_time + j_step * 0.5)[..., None]
            j_h = jnp.linalg.norm(j_pos, axis=-1) - r_planet
            return (j_od_rlh + jnp.exp(-j_h / sh_rlh) * j_step,
                    j_od_mie + jnp.exp(-j_h / sh_mie) * j_step)

        j_od_rlh, j_od_mie = lax.fori_loop(
            0, j_steps, j_body,
            (jnp.zeros_like(j_step), jnp.zeros_like(j_step)))

        attn = jnp.exp(-(k_mie * (i_od_mie + j_od_mie)[..., None]
                         + k_rlh * (i_od_rlh + j_od_rlh)[..., None]))
        total_rlh = total_rlh + od_rlh[..., None] * attn
        total_mie = total_mie + od_mie[..., None] * attn
        return (i_time + i_step, total_rlh, total_mie, i_od_rlh, i_od_mie)

    (_, total_rlh, total_mie, _, _) = lax.fori_loop(
        0, i_steps, i_body,
        (i_time, total_rlh, total_mie, i_od_rlh, i_od_mie))

    out = i_sun * (p_rlh[..., None] * k_rlh * total_rlh
                   + p_mie[..., None] * k_mie * total_mie)
    return jnp.where(miss[..., None], 0.0, out)


def render_clouds(g, depth_full, noise_tex, width: int, height: int,
                  full_width: int | None = None,
                  full_height: int | None = None):
    """The full T12 compute pass at half resolution.

    depth_full: (H, W) full-res depth (sampled for the sky test);
    noise_tex: (N, N) float32 tiled noise (assets/Clouds/noise.png R).
    Returns (3, height, width) sky colour (half res).

    full_width/full_height: the reference QUADRANT quirk — its clouds
    image is half the window (renderer.cpp:829-831) but the shader
    divides the half-res pixel coordinate by the FULL window resolution
    (``ray_uv = pixel / (globals.resolution - 1)``,
    cloud_rendering.inl:443-445), so ray_uv spans only [0, ~0.5]²: the
    pass marches the top-left frustum quadrant (and samples the
    top-left of the depth buffer for its sky mask), and composition
    stretches that quadrant over the whole screen by sampling the
    half-res image at full-screen uv (composition.inl:221).  Pass the
    full-res dimensions to reproduce it; None = rays span the whole
    frustum (the corrected behaviour, used by the LUT-error tests).
    """
    from . import sampling
    fw = width if full_width is None else full_width
    fh = height if full_height is None else full_height
    px = jnp.arange(width, dtype=jnp.float32)
    py = jnp.arange(height, dtype=jnp.float32)
    pix = jnp.stack(jnp.meshgrid(px, py, indexing="xy"), -1)  # (h, w, 2)
    # :445 quirk: uv = pixel / (resolution - 1), resolution = FULL window
    ray_uv = pix / jnp.array([fw - 1.0, fh - 1.0], jnp.float32)
    ndc = ray_uv * 2.0 - 1.0

    # ray directions at HIGHEST precision: a TF32 product would round
    # the unprojected directions to ~3 digits
    hi = jax.lax.Precision.HIGHEST
    inv_p = g.camera.inv_projection
    view = jnp.matmul(jnp.stack([ndc[..., 0], ndc[..., 1],
                                 -jnp.ones_like(ndc[..., 0]),
                                 jnp.zeros_like(ndc[..., 0])], -1),
                      inv_p.T, precision=hi)
    inv_v = g.camera.inv_view
    world4 = jnp.matmul(jnp.stack([view[..., 0], view[..., 1],
                                   -jnp.ones_like(ndc[..., 0]),
                                   jnp.zeros_like(ndc[..., 0])], -1),
                        inv_v.T, precision=hi)
    ray_dir = world4[..., :3]
    ray_dir = ray_dir / jnp.maximum(
        jnp.linalg.norm(ray_dir, axis=-1, keepdims=True), 1e-12)
    sun_dir = -g.sun.direction

    # sample_screen expects PLANAR (2, h, w) uv
    d = sampling.sample_screen(depth_full,
                               jnp.stack([ray_uv[..., 0], ray_uv[..., 1]]))
    sky_mask = d == 1.0

    color = jnp.broadcast_to(jnp.array([0.2, 0.4, 1.0], jnp.float32),
                             ray_dir.shape)
    dither = bayer16(pix)
    origin = jnp.array([0.0, 6372e3, 0.0], jnp.float32) + g.camera.position
    atmos = _atmosphere(ray_dir, origin, sun_dir, g.elapsed_time)
    sky = _volumetric_clouds(ray_dir, sun_dir, atmos, dither,
                             jnp.array([0.8, 0.8, 0.8], jnp.float32),
                             g.camera.position, g.elapsed_time, noise_tex)
    horizon = jnp.maximum(
        jnp.minimum(jnp.abs(sun_dir[0]), jnp.abs(sun_dir[2])) + sun_dir[1],
        0.0)
    sky = sky * horizon
    out = jnp.where(sky_mask[..., None], sky, color)
    return out.transpose(2, 0, 1)


# ---------------------------------------------------------------------------
# Sky LUT path (the production path)
# ---------------------------------------------------------------------------
#
# The reference cloud field is CAMERA-RELATIVE in xz (get_clouds does
# ``p.xz += camera_position.xz`` on ray-relative positions, :237), so
# for a given frame the whole sky is a function of ray direction only.
# Instead of marching every sky pixel, march a small lat-long direction
# LUT (procedural noise -> zero gathers, pure VPU) and look it up per
# pixel.  The bayer dither becomes LUT interpolation smoothing.


def render_sky_lut(g, lut_w: int = 256, lut_h: int = 128,
                   noise_tex=None):
    """March the full atmosphere+clouds over a lat-long direction LUT.

    Returns (3, lut_h, lut_w): azimuth in [-pi, pi) across width,
    elevation in [-pi/2, pi/2] across height.
    """
    az = (jnp.arange(lut_w, dtype=jnp.float32) + 0.5) / lut_w * 2.0 * jnp.pi - jnp.pi
    el = (jnp.arange(lut_h, dtype=jnp.float32) + 0.5) / lut_h * jnp.pi - jnp.pi / 2
    ca, sa = jnp.cos(az)[None, :], jnp.sin(az)[None, :]
    ce, se = jnp.cos(el)[:, None], jnp.sin(el)[:, None]
    ray = jnp.stack([jnp.broadcast_to(ce * ca, (lut_h, lut_w)),
                     jnp.broadcast_to(se, (lut_h, lut_w)),
                     jnp.broadcast_to(ce * sa, (lut_h, lut_w))], -1)

    sun_dir = -g.sun.direction
    origin = jnp.array([0.0, 6372e3, 0.0], jnp.float32) + g.camera.position
    atmos = _atmosphere(ray, origin, sun_dir, g.elapsed_time)
    sky = _volumetric_clouds(ray, sun_dir, atmos,
                             jnp.full((lut_h, lut_w), 0.5, jnp.float32),
                             jnp.array([0.8, 0.8, 0.8], jnp.float32),
                             g.camera.position, g.elapsed_time, noise_tex)
    horizon = jnp.maximum(
        jnp.minimum(jnp.abs(sun_dir[0]), jnp.abs(sun_dir[2])) + sun_dir[1],
        0.0)
    return (sky * horizon).transpose(2, 0, 1)


def sky_from_lut(g, lut, depth_full, width: int, height: int,
                 dither: bool = True,
                 full_width: int | None = None,
                 full_height: int | None = None):
    """Per-pixel sky via LUT lookup at the pixel's ray direction.

    Matches render_clouds' ray construction (:445-455 quirks: uv uses
    resolution-1; view ray built from inverse view of (vx, vy, -1, 0)),
    including the QUADRANT quirk when full_width/full_height are given
    (see render_clouds: the half-res pixel is divided by the FULL
    window resolution, so rays and the depth sky-mask cover only the
    top-left frustum quadrant, which composition stretches fullscreen).
    Returns (3, height, width) half-res sky colour.

    dither: offset the LUT lookup by the reference's bayer16 pattern
    (±half a LUT texel) — the analog of the reference's dithered march
    start (cloud_rendering.inl:461): it trades the LUT's angular
    quantization banding for the same high-frequency noise the
    reference shows (VERDICT r2 item 6).
    """
    from . import sampling
    fw = width if full_width is None else full_width
    fh = height if full_height is None else full_height
    px = jnp.arange(width, dtype=jnp.float32)
    py = jnp.arange(height, dtype=jnp.float32)
    u = jnp.broadcast_to(px[None, :] / (fw - 1.0), (height, width))
    v = jnp.broadcast_to(py[:, None] / (fh - 1.0), (height, width))
    ndc_x = u * 2.0 - 1.0
    ndc_y = v * 2.0 - 1.0

    inv_p = g.camera.inv_projection
    vx = inv_p[0, 0] * ndc_x + inv_p[0, 1] * ndc_y - inv_p[0, 2] + 0 * inv_p[0, 3]
    vy = inv_p[1, 0] * ndc_x + inv_p[1, 1] * ndc_y - inv_p[1, 2]
    inv_v = g.camera.inv_view
    wx = inv_v[0, 0] * vx + inv_v[0, 1] * vy - inv_v[0, 2]
    wy = inv_v[1, 0] * vx + inv_v[1, 1] * vy - inv_v[1, 2]
    wz = inv_v[2, 0] * vx + inv_v[2, 1] * vy - inv_v[2, 2]
    n = jnp.sqrt(jnp.maximum(wx * wx + wy * wy + wz * wz, 1e-12))
    dx, dy, dz = wx / n, wy / n, wz / n

    az = jnp.arctan2(dz, dx)
    el = jnp.arcsin(jnp.clip(dy, -1.0, 1.0))
    lu = (az + jnp.pi) / (2.0 * jnp.pi)
    lv = (el + jnp.pi / 2) / jnp.pi
    lut_h, lut_w = lut.shape[1], lut.shape[2]
    if dither:
        pix = jnp.stack(
            [jnp.broadcast_to(px[None, :], (height, width)),
             jnp.broadcast_to(py[:, None], (height, width))], axis=-1)
        d16 = bayer16(pix) - 0.5                     # (height, width)
        lu = lu + d16 / lut_w
        lv = lv + d16 / lut_h
    # azimuth WRAPS: sample_screen clamps to edge, which would leave a
    # vertical seam at az = ±pi (last LUT column never interpolates
    # toward the first).  Route the bilinear through a 1-column-padded
    # copy: texel i of the original sits at padded texel i+1, so
    # u_p = (lu*W + 1)/(W + 2) reproduces the same taps with wrapped
    # neighbours at both edges (also covers the ±half-texel dither).
    lu = lu - jnp.floor(lu)
    lut_p = jnp.concatenate([lut[:, :, -1:], lut, lut[:, :, :1]], axis=2)
    lu_p = (lu * lut_w + 1.0) / (lut_w + 2.0)
    sky = sampling.sample_screen(lut_p, jnp.stack([lu_p, lv]))

    # the sky-mask depth resample has SEPARABLE indices (u is a
    # function of x only, v of y only — the quirky /(res-1) mapping
    # included), so the per-pixel flat gather (~3.3 ms at 1080p half
    # res) collapses to 4 one-dimensional gathers, bit-identically
    d = sampling.sample_screen_separable(
        depth_full, px / (fw - 1.0), py / (fh - 1.0))
    base = jnp.array([0.2, 0.4, 1.0], jnp.float32)[:, None, None]
    return jnp.where((d == 1.0)[None], sky, base)
