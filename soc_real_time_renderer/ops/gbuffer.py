"""Deferred G-buffer resolve from the visibility buffer.

Implements the fragment-shader half of the reference's G-buffer pass
(``/root/reference/src/graphics/tasks/g_buffer_generation.inl:152-233``)
as a deferred full-screen op over the visibility buffer: each pixel
performs exactly ONE fat record gather (everything its triangle
carries) plus one packed texture-tap gather per mip level sampled, and
all vector math is planar (components on the leading axis).

Reference semantics preserved:

* perspective-correct interpolation of uv/normal/world position;
* albedo = albedo_tex.rgb **+ emissive** (``:194``), emissive separate;
* normal mapping with TBN from position/uv derivatives (``:198-213``)
  — exact analytic per-triangle derivatives instead of 2x2-quad
  finite differences;
* metallic-roughness from texture G/B stored as R=rough, G=metal
  (``:219-224``);
* velocity = current NDC uv - previous NDC uv, previous camera x
  current transform (``:226-229``);
* terrain fragments (``draw_terrain.inl:203-221``): normal map used
  directly as the world normal, velocity = 0;
* sky clear colour (0.2, 0.4, 1.0) on no-hit pixels (``:80``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import jax
import jax.numpy as jnp

from ..utils.vec import cross3, normalize3
from .raster2 import PlanarSetup
from .raster2 import VisibilityBuffer

SKY_CLEAR = (0.2, 0.4, 1.0)  # g_buffer_generation.inl:80


def _pytree(cls):
    jax.tree_util.register_dataclass(
        cls, data_fields=[f.name for f in dataclasses.fields(cls)],
        meta_fields=[])
    return cls


@_pytree
@dataclass(frozen=True)
class GBuffer:
    """The reference's 5 MRT targets (renderer.cpp:348-470), planar."""
    albedo: jax.Array               # (3, H, W)
    emissive: jax.Array             # (3, H, W)
    normal: jax.Array               # (3, H, W)
    metallic_roughness: jax.Array   # (2, H, W): R=roughness, G=metallic
    velocity: jax.Array             # (2, H, W) uv-space
    depth: jax.Array                # (H, W)


def build_shading_records(setup: PlanarSetup, world_pos, world_nrm,
                          tri_uv, static_rows, pack: str = "hilo"):
    """Per-triangle shading records (one gather per pixel).

    world_pos/world_nrm: (3 verts, 3 xyz, T); tri_uv: (3 verts, 2, T);
    static_rows: (5, T).  f32 rows [adj 9 | wpos 9 | wnrm 9 | uv 6 |
    material_id, has_normal, has_mr, has_emissive, is_terrain | 2 pad].

    pack="hilo": (80, T+1) bfloat16 — bf16 hi (rows 0-39) + bf16
    lo = x - f32(hi) (rows 40-79); hi + lo recovers ~16 mantissa bits,
    full precision for interpolation weights/attributes at screen
    scale.

    pack="u32": (40, T+1) int32 — the SAME hi/lo bf16 bit patterns
    packed hi<<16 | lo per row: identical reconstructed values (resolve
    bitcasts the halves back to f32 and adds), half the gathered
    elements.

    pack="f32": (40, T+1) float32 — the raw rows, no precision split
    and no reconstruction math in the resolve.

    Column T = sentinel.
    """
    T = setup.adj.shape[1]
    rec = jnp.concatenate([
        setup.adj,
        world_pos.reshape(9, T),
        world_nrm.reshape(9, T),
        tri_uv.reshape(6, T),
        static_rows,
        jnp.zeros((2, T), jnp.float32),
    ], axis=0)
    rec = jnp.concatenate([rec, jnp.zeros((40, 1), jnp.float32)], axis=1)
    if pack == "f32":
        return rec
    # reduce_precision, not f32(bf16(rec)): excess-precision folding can
    # cancel the convert pair and zero the residual
    hi_f = jax.lax.reduce_precision(rec, 8, 7)
    hi = hi_f.astype(jnp.bfloat16)
    lo = jax.lax.reduce_precision(rec - hi_f, 8, 7).astype(jnp.bfloat16)
    if pack == "u32":
        hi16 = jax.lax.bitcast_convert_type(hi, jnp.uint16)
        lo16 = jax.lax.bitcast_convert_type(lo, jnp.uint16)
        return jax.lax.bitcast_convert_type(
            (hi16.astype(jnp.uint32) << 16) | lo16.astype(jnp.uint32),
            jnp.int32)
    return jnp.concatenate([hi, lo], axis=0)


def _srgb_to_linear(x):
    return jnp.where(x <= 0.04045, x / 12.92,
                     ((x + 0.055) / 1.055) ** 2.4)


def sample_packed_atlas(atlas, mid, uv, lod, *, size: int,
                        layer_stride: int, n_levels: int,
                        filter_mode: str = "bilinear"):
    """Sample all 4 material textures at once from the packed atlas.

    atlas: (N, 12) int32 ROW-MAJOR — each texel row packs the 11
    sampled channels (texture.SAMPLED_ROWS: albedo RGB, normal RGB,
    mr GB, emissive RGB) x 4 wrap-shifted bilinear corners as u32
    lanes ``c00|c10<<8|c01<<16|c11<<24`` (texture.
    expand_atlas_bilinear), so a bilinear tap is ONE gather whose
    bytes are contiguous in memory.  mid: (P,) int32; uv: (2, P);
    lod: (P,).  Returns (11, P) float32 in [0, 1] in SAMPLED_ROWS
    order.  level_off(l) = (4S² - 4(S>>l)²)/3 — arithmetic, no table
    gathers.
    """
    uvw = uv - jnp.floor(uv)
    base_m = mid * layer_stride

    def level_fetch(l, bilinear):
        s = jnp.right_shift(jnp.int32(size), l)
        off = (4 * size * size - 4 * s * s) // 3
        x = uvw[0] * s.astype(jnp.float32) - 0.5
        y = uvw[1] * s.astype(jnp.float32) - 0.5
        x0 = jnp.floor(x)
        y0 = jnp.floor(y)
        fx = x - x0
        fy = y - y0

        def tap_idx(xi, yi):
            xw = jnp.remainder(xi, s)
            yw = jnp.remainder(yi, s)
            return jax.lax.optimization_barrier(base_m + off + yw * s + xw)

        if not bilinear:
            idx = tap_idx(jnp.round(x).astype(jnp.int32),
                          jnp.round(y).astype(jnp.int32))
            c = atlas[idx][:, :11].T                             # (11, P)
            return (c & 255).astype(jnp.float32) / 255.0
        c = atlas[tap_idx(x0.astype(jnp.int32),
                          y0.astype(jnp.int32))][:, :11].T       # (11, P)
        c00 = (c & 255).astype(jnp.float32)
        c10 = ((c >> 8) & 255).astype(jnp.float32)
        c01 = ((c >> 16) & 255).astype(jnp.float32)
        c11 = ((c >> 24) & 255).astype(jnp.float32)
        return ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
                + (c01 * (1 - fx) + c11 * fx) * fy) / 255.0

    lod = jnp.clip(lod, 0.0, float(n_levels - 1))
    if filter_mode == "none":
        # attribution probe (tools/bench_toggle.py): constant texel,
        # zero atlas gathers — NOT a rendering mode
        return jnp.broadcast_to(jnp.float32(0.5), (11,) + uv.shape[1:])
    if filter_mode == "nearest":
        return level_fetch(jnp.round(lod).astype(jnp.int32), bilinear=False)
    if filter_mode == "bilinear":
        return level_fetch(jnp.round(lod).astype(jnp.int32), bilinear=True)
    l0 = jnp.floor(lod).astype(jnp.int32)
    l1 = jnp.minimum(l0 + 1, n_levels - 1)
    f = lod - l0.astype(jnp.float32)
    return level_fetch(l0, True) * (1 - f) + level_fetch(l1, True) * f


def resolve_gbuffer(vis: VisibilityBuffer, shading_records, atlas,
                    prev_view_proj, *, atlas_size: int, layer_stride: int,
                    n_levels: int, filter_mode: str = "bilinear",
                    stub_records: bool = False) -> GBuffer:
    """Shade the visibility buffer into the 5-target G-buffer; material
    textures are sampled by one gather per tap from the packed atlas
    (sample_packed_atlas)."""
    H, W = vis.depth.shape
    T = shading_records.shape[1] - 1

    tri = vis.tri_id.reshape(-1)
    miss = tri < 0
    t = jax.lax.optimization_barrier(jnp.where(miss, T, tri))

    px = (jnp.arange(W, dtype=jnp.float32) + 0.5)[None, :]
    py = (jnp.arange(H, dtype=jnp.float32) + 0.5)[:, None]
    px = jnp.broadcast_to(px, (H, W)).reshape(-1)
    py = jnp.broadcast_to(py, (H, W)).reshape(-1)

    if stub_records:
        # --- attribution stub (tools/bench_toggle.py stub_records):
        # skip the fat record gather and the interpolation math derived
        # from it; synthesize spatially-plausible attributes instead —
        # mid constant over 128-px blocks, uv/lod varying smoothly so
        # the texture taps keep realistic index diversity.  NOT a
        # rendering mode.
        pxn = px / W
        pyn = py / H
        zero = jnp.zeros_like(px)
        one = jnp.ones_like(px)
        pos = jnp.stack([pxn * 20.0 - 10.0, pyn * 20.0 - 10.0, zero])
        pos_dx = jnp.stack([jnp.full_like(px, 0.01), zero, zero])
        pos_dy = jnp.stack([zero, jnp.full_like(px, 0.01), zero])
        nrm = jnp.stack([zero, zero, one])
        uv = jnp.stack([pxn * 7.3, pyn * 7.3])
        dv_dx = zero
        dv_dy = jnp.full_like(px, 7.3 / H)
        mid = ((px.astype(jnp.int32) // 128 + py.astype(jnp.int32) // 128)
               % max(atlas.shape[0] // layer_stride, 1))
        has_n, has_mr, has_e, is_ter = one, one, zero, zero
        lod = pxn * 3.0
    else:
        # barrier: the gather result feeds many consumer chains —
        # without it XLA's consumer fusion can duplicate the fat gather
        # per consumer
        rhl = jax.lax.optimization_barrier(
            shading_records[:, t])  # (80,P) bf16 hi/lo | (40,P) u32 | f32
        if shading_records.dtype == jnp.int32:
            # u32-packed stream: unpack the two bf16 halves back to f32
            # (a bf16 bit pattern in the TOP 16 bits of an i32 IS the
            # f32 of that bf16 value) — exact same values as the hilo
            # layout, half the gathered elements
            hi = jax.lax.bitcast_convert_type(
                rhl & jnp.int32(-65536), jnp.float32)
            lo = jax.lax.bitcast_convert_type(rhl << 16, jnp.float32)
            rec = hi + lo
        elif shading_records.dtype == jnp.float32:
            rec = rhl                       # pack="f32": rows as-is
        else:
            rec = (rhl[:40].astype(jnp.float32)
                   + rhl[40:].astype(jnp.float32))

        # edge values + derivatives (de/dx = adj col 0, de/dy = col 1)
        e = jnp.stack([rec[0] * px + rec[1] * py + rec[2],
                       rec[3] * px + rec[4] * py + rec[5],
                       rec[6] * px + rec[7] * py + rec[8]])   # (3, P)
        ex = jnp.stack([rec[0], rec[3], rec[6]])
        ey = jnp.stack([rec[1], rec[4], rec[7]])
        D = e[0] + e[1] + e[2]
        Dx = ex[0] + ex[1] + ex[2]
        Dy = ey[0] + ey[1] + ey[2]
        invD = 1.0 / jnp.where(D != 0, D, 1.0)

        def interp(r0, r1, r2):
            """Perspective-correct value + d/dx + d/dy for a per-vertex
            attribute given its three rows (P,)."""
            N = e[0] * r0 + e[1] * r1 + e[2] * r2
            Nx = ex[0] * r0 + ex[1] * r1 + ex[2] * r2
            Ny = ey[0] * r0 + ey[1] * r1 + ey[2] * r2
            val = N * invD
            return val, (Nx - val * Dx) * invD, (Ny - val * Dy) * invD

        def interp3(base):
            """rows base+{0..8} hold vertex-major (v, c) attrs: row =
            base + v*3 + c.  Returns ((3, P) value, ddx, ddy)."""
            vals, dxs, dys = [], [], []
            for c in range(3):
                v, dx, dy = interp(rec[base + c], rec[base + 3 + c],
                                   rec[base + 6 + c])
                vals.append(v)
                dxs.append(dx)
                dys.append(dy)
            return jnp.stack(vals), jnp.stack(dxs), jnp.stack(dys)

        pos, pos_dx, pos_dy = interp3(9)
        nrm, _, _ = interp3(18)
        uv_u, du_dx, du_dy = interp(rec[27], rec[29], rec[31])
        uv_v, dv_dx, dv_dy = interp(rec[28], rec[30], rec[32])
        uv = jnp.stack([uv_u, uv_v])                 # (2, P)

        mid = jnp.round(rec[33]).astype(jnp.int32)
        has_n = rec[34]
        has_mr = rec[35]
        has_e = rec[36]
        is_ter = rec[37]

        lod_sq = jnp.maximum(du_dx ** 2 + dv_dx ** 2,
                             du_dy ** 2 + dv_dy ** 2) * (atlas_size ** 2)
        lod = 0.5 * jnp.log2(jnp.maximum(lod_sq, 1e-12))

    tex = sample_packed_atlas(atlas, mid, uv, lod, size=atlas_size,
                              layer_stride=layer_stride, n_levels=n_levels,
                              filter_mode=filter_mode)        # (11, P)
    # render-target barrier on the sampled texel block: without it its
    # four consumer chains (albedo/normal/mr/emissive) invite XLA to
    # fuse and recompute the tap per consumer
    tex = jax.lax.optimization_barrier(tex)
    albedo_t = _srgb_to_linear(tex[0:3])
    normal_t = tex[3:6]
    mr_gb = tex[6:8]
    emissive_t = _srgb_to_linear(tex[8:11])

    emissive = emissive_t * has_e
    albedo = albedo_t + emissive                       # inl:194
    mr = mr_gb * has_mr

    # normal mapping (inl:198-213)
    n = normalize3(nrm)
    tn = normal_t * 2.0 - 1.0
    tvec = normalize3(pos_dx * dv_dy - pos_dy * dv_dx)
    bvec = normalize3(cross3(n, tvec))
    mapped = normalize3(tvec * tn[0] + bvec * tn[1] + n * tn[2])
    normal = mapped * has_n + n * (1.0 - has_n)
    # terrain path: the normal map IS the world normal (decoded), no TBN
    normal = normalize3(tn) * is_ter + normal * (1.0 - is_ter)

    # velocity (inl:226-229)
    cur_u = px / W
    cur_v = py / H
    pc_x = (prev_view_proj[0, 0] * pos[0] + prev_view_proj[0, 1] * pos[1]
            + prev_view_proj[0, 2] * pos[2] + prev_view_proj[0, 3])
    pc_y = (prev_view_proj[1, 0] * pos[0] + prev_view_proj[1, 1] * pos[1]
            + prev_view_proj[1, 2] * pos[2] + prev_view_proj[1, 3])
    pc_w = (prev_view_proj[3, 0] * pos[0] + prev_view_proj[3, 1] * pos[1]
            + prev_view_proj[3, 2] * pos[2] + prev_view_proj[3, 3])
    wsafe = jnp.where(pc_w != 0, pc_w, 1.0)
    vel_u = cur_u - (pc_x / wsafe * 0.5 + 0.5)
    vel_v = cur_v - (pc_y / wsafe * 0.5 + 0.5)
    not_ter = 1.0 - is_ter                 # terrain velocity = 0 (:220)
    velocity = jnp.stack([vel_u, vel_v]) * not_ter

    live = (~miss).astype(jnp.float32)
    sky = jnp.array(SKY_CLEAR, jnp.float32)[:, None]
    albedo = albedo * live + sky * (1.0 - live)
    emissive = emissive * live
    normal = normal * live
    mr = mr * live
    velocity = velocity * live

    def plane(x):
        return x.reshape(x.shape[0], H, W)

    return GBuffer(albedo=plane(albedo), emissive=plane(emissive),
                   normal=plane(normal), metallic_roughness=plane(mr),
                   velocity=plane(velocity), depth=vis.depth)
