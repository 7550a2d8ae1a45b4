"""The frame graph: one pure jitted function per frame.

Replaces the reference's Daxa TaskGraph (``renderer.cpp:929-1235``) —
~25 tasks with inferred barriers — with plain data flow inside a single
``render_frame(batch, globals, history) -> (frame, history')`` function.
Pass order matches the reference graph (SURVEY.md §3.2):

  raster (visibility) -> HiZ -> SunShadow -> Terrain -> G-buffer ->
  Bloom -> SSAO(+blur) -> SSR -> Clouds -> Composition ->
  Histogram/Exposure -> TAA -> ToneMapping

Cross-frame state (previous colour/velocity for TAA, auto-exposure) is
threaded explicitly as the ``RenderHistory`` carry, replacing the
copy-image tasks (``renderer.cpp:1182-1198``) and the exposure buffer
(``renderer.cpp:292-308``).

Pass toggles live in the static :class:`~..config.RenderConfig` so XLA
compiles exactly the enabled pipeline (the analog of commenting tasks
in/out of the reference graph).
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp

from ..config import RenderConfig, ShaderGlobals
from ..models.scene_batch import SceneBatch
from ..models.texture import PackedMaterialAtlas
from ..ops import bloom as bloom_ops
from ..ops import clouds as clouds_ops
from ..ops import composition as comp_ops
from ..ops import exposure as exposure_ops
from ..ops import gbuffer as gbuf_ops
from ..ops import raster2
from ..ops import sampling
from ..ops import ssao as ssao_ops
from ..ops import ssr as ssr_ops
from ..ops import taa as taa_ops
from ..ops import tonemap as tonemap_ops


def _pytree(cls):
    jax.tree_util.register_dataclass(
        cls, data_fields=[f.name for f in dataclasses.fields(cls)],
        meta_fields=[])
    return cls


@_pytree
@dataclass(frozen=True)
class RenderHistory:
    """Cross-frame carry (SURVEY.md §5 checkpoint/resume analysis).

    History rides in bfloat16, the RGBA16F history-target analog: half
    the bytes of the TAA reprojection fetch.
    """
    previous_color: jax.Array      # (3, H, W) bf16 resolved colour pre-tonemap
    previous_velocity: jax.Array   # (2, H, W) bf16
    exposure: jax.Array            # () f32 auto-exposure state

    @staticmethod
    def create(config: RenderConfig):
        h, w = config.height, config.width
        return RenderHistory(
            previous_color=jnp.zeros((3, h, w), jnp.bfloat16),
            previous_velocity=jnp.zeros((2, h, w), jnp.bfloat16),
            exposure=jnp.float32(0.0),
        )


@dataclass(frozen=True)
class FramePlan:
    """Static per-scene/per-config raster grids + atlas metadata."""
    config: RenderConfig
    main_grid: raster2.BinGrid
    shadow_grid: raster2.BinGrid
    atlas_size: int
    atlas_layer_stride: int
    atlas_n_levels: int
    texture_filter: str = "bilinear"
    # Shading-record stream layout (gbuffer.build_shading_records):
    # "hilo" = (80, T+1) bf16, "u32" = (40, T+1) int32 with the same
    # bf16 bit patterns packed hi<<16|lo — identical reconstructed
    # values, half the gathered elements; "f32" = (40, T+1) float32 raw
    # rows.
    rec_pack: str = "hilo"
    # Pallas interpret override for tests; None = the platform rule
    # (ops/backend.py: compiled on the GPU, interpreted on the CPU)
    interpret: bool | None = None
    # Multi-device (SURVEY §2.6 P6): when set, shade_stage pins every
    # render target to rows-split-over-`shard_axis` of `shard_mesh`, so
    # XLA partitions the whole screen-space stack across devices (halo
    # exchanges become collective-permutes).  Geometry / records stay
    # replicated — they are the "weights".
    shard_mesh: object | None = None      # jax.sharding.Mesh (hashable)
    shard_axis: str | None = None         # mesh axis name for image rows
    # Statically-provable-empty sun shadow map (scenes.py sets this):
    # the REFERENCE's shadow volume never contains the scene — sun at
    # y=40 with glm::ortho(+-16) z planes (renderer.cpp:110-112) and
    # glm running in [-1,1] depth mode because the ZO macro is
    # misspelled (pch.hpp:17 'GLM_DEPTH_ZERO_TO_ONEW', camera.hpp:5
    # missing the FORCE_ prefix) puts ALL geometry at sun-clip
    # z~2.2-2.75, so every fragment z-clips and the 4096^2 map stays at
    # its 1.0 clear (sun_shadow = exp(-80(z-1)) ~ 0 in composition).
    # When provable at build time, the raster + ESM gather are elided
    # and composition uses the exact constant-1.0 map analytically —
    # output-identical, and a 4096² raster cheaper.
    shadow_statically_empty: bool = False
    # The sun projection_view the emptiness proof was run against
    # (flattened row-major tuple, hashable).  make_render_fn verifies
    # each frame's g.sun against it: the proof is only sound for the
    # proved matrices, and silently substituting the 1.0 map under a
    # different sun would render wrong shadows with no error.
    proved_sun_pv: tuple | None = None
    # Static shadow-map sampling crop (x0, y0, w, h) in texels, proved
    # at scene build (scenes._prove_shadow): every texel outside it is
    # exactly the 1.0 clear, so composition's ESM factor samples a
    # small slice instead of the full 4096² table — bit-identical
    # output.  None = sample the full map.
    shadow_crop: tuple | None = None
    # The flattened model matrices the crop was proved against (ADVICE
    # r4): unlike proved_sun_pv, the crop depends on the GEOMETRY's
    # world placement, so rendering with different model_mats under a
    # stale crop would silently lose shadows from geometry that moved
    # outside it.  make_render_fn / render_frame reject mismatches
    # host-side (check_shadow_crop).  None = crop unguarded (only when
    # shadow_crop is also None).
    proved_crop_mats: tuple | None = None
    # SSR march compaction cap (ops/ssr.py): > 0 marches only the
    # compacted reflective pixels (metallic >= 0.01, the reference's
    # early return inl:175-178) up to this many, with OVERFLOW_SSR_CAP
    # + FrameOutputs.ssr_active as the guard/telemetry pair.  0 = dense
    # march of every pixel.
    # scenes._finish sizes it from the screen area.
    ssr_cap: int = 0
    # Attribution stubs (tools/bench_toggle.py; VERDICT r3 item 1) —
    # NOT rendering modes.  "": off.  "resolve": fabricate the main
    # visibility buffer after binning (delta = main resolve kernel).
    # "shadow_resolve": same for the shadow view.  "records": skip the
    # G-buffer record gather (delta = fat gather + interpolation).
    # "unlit": composition = albedo passthrough (delta = lighting).
    stub: str = ""
    # Materialize vis.depth/tri_id behind an optimization_barrier
    # before the shade stage: the visibility buffer is a padded kernel
    # output that every screen-space pass reads through a crop slice,
    # and without the barrier XLA may re-fuse the crop into each
    # consumer.  Default ON; False only for the bench_toggle A/B probe.
    vis_barrier: bool = True

    @staticmethod
    def create(config: RenderConfig, atlas: PackedMaterialAtlas,
               texture_filter: str = "bilinear", scale: str = "scene",
               interpret: bool | None = None):
        main = raster2.default_grid(config.width, config.height, scale)
        shadow = raster2.default_grid(config.shadow_resolution,
                                      config.shadow_resolution, scale,
                                      kind="shadow")
        return FramePlan(config=config, main_grid=main, shadow_grid=shadow,
                         atlas_size=atlas.size,
                         atlas_layer_stride=atlas.layer_stride,
                         atlas_n_levels=atlas.n_levels,
                         texture_filter=texture_filter,
                         interpret=interpret)


@_pytree
@dataclass(frozen=True)
class FrameOutputs:
    """All intermediate targets (the debug-dump analog of
    DisplayAttachmentTask, display_attachment.inl:23-64)."""
    color: jax.Array               # (3, H, W) final tonemapped [0,1]
    hdr: jax.Array                 # (3, H, W) pre-tonemap
    gbuffer: gbuf_ops.GBuffer
    shadow_map: jax.Array | None
    ssao: jax.Array | None
    clouds: jax.Array | None
    bloom: jax.Array | None
    ssr: jax.Array | None
    hiz_min: list | None           # HiZ pyramids (T2/T3,
    hiz_max: list | None           #   generate_hiz.glsl:17-99); level 0
    #                                 is half-res, down to 1x1
    overflow: jax.Array            # () int32 raster2.OVERFLOW_* bitmask
    #                                 (main | shadow views) — nonzero
    #                                 means a static binning cap dropped
    #                                 fragments this frame; see
    #                                 raster2.build_pairs.
    ssr_active: jax.Array          # () int32 — reflective pixels the
    #                                 SSR march compacted to this frame
    #                                 (-1: dense march or SSR off);
    #                                 sizes FramePlan.ssr_cap from data.


def transform_triangles(batch: SceneBatch, model_mats, normal_mats):
    """World transform of the planar triangle batch: entity matrices
    selected by a one-hot product (E is tiny); all per-triangle arrays
    keep T on the last axis.  The product runs at HIGHEST precision —
    a TF32 select would round every vertex position to ~3 digits."""
    E = model_mats.shape[0]
    onehot = (batch.tri_entity[None, :]
              == jnp.arange(E, dtype=jnp.int32)[:, None]).astype(jnp.float32)
    hi = jax.lax.Precision.HIGHEST
    mats = jnp.matmul(model_mats.reshape(E, 16).T, onehot,
                      precision=hi)                    # (16, T)
    nmats = jnp.matmul(normal_mats.reshape(E, 16).T, onehot, precision=hi)

    def apply(m16, pts, translate):
        # m16: (16, T) row-major 4x4 per triangle; pts: (3, 3, T)
        out = []
        for v in range(3):
            p = pts[v]
            rows = []
            for i in range(3):
                r = (m16[i * 4 + 0] * p[0] + m16[i * 4 + 1] * p[1]
                     + m16[i * 4 + 2] * p[2])
                if translate:
                    r = r + m16[i * 4 + 3]
                rows.append(r)
            out.append(jnp.stack(rows))
        return jnp.stack(out)                         # (3, 3, T)

    world = apply(mats, batch.tri_pos, True)
    wnrm = apply(nmats, batch.tri_nrm, False)
    return world, wnrm


def _clip_of(world, view_proj):
    """world (3, 3, T) -> clip (3 verts, 4, T) planar."""
    outs = []
    for v in range(3):
        p = world[v]
        comps = [view_proj[i, 0] * p[0] + view_proj[i, 1] * p[1]
                 + view_proj[i, 2] * p[2] + view_proj[i, 3]
                 for i in range(4)]
        outs.append(jnp.stack(comps))
    return jnp.stack(outs)


def raster_stage(plan: FramePlan, batch: SceneBatch, g: ShaderGlobals,
                 model_mats, normal_mats):
    """Geometry half of the frame: vertex transform + the raster views
    (T1 main visibility + T4 shadow) + per-triangle shading records.
    Under multi-device SPMD the setup/binning (per-triangle, small next
    to pixel counts) is replicated but the resolve — the
    pixel×triangle coverage work, i.e. the raster COST — splits over
    bin rows (raster2.resolve_row_sharded), so raster latency scales
    with devices like the rest of the frame."""
    cfg = plan.config
    shard = ((plan.shard_mesh, plan.shard_axis)
             if plan.shard_mesh is not None and plan.shard_axis is not None
             else None)
    world, wnrm = transform_triangles(batch, model_mats, normal_mats)
    clip = _clip_of(world, g.camera.projection_view)
    if plan.stub == "raster":
        # attribution stub: skip binning AND resolve for the main view
        # (setup still runs — the shading records need it); combined
        # with stub="resolve" (binning kept) this splits the raster
        # cost into binning vs resolve-kernel parts.
        setup = raster2.triangle_setup_planar(
            clip, plan.main_grid.width, plan.main_grid.height, "front")
        vis = raster2.stub_vis(plan.main_grid.height, plan.main_grid.width,
                               batch.num_triangles)
        vis = dataclasses.replace(
            vis, depth=vis.depth[:cfg.height, :cfg.width],
            tri_id=vis.tri_id[:cfg.height, :cfg.width])
    else:
        vis, setup = raster2.rasterize(clip, plan.main_grid, cull="front",
                                       interpret=plan.interpret,
                                       shard=shard,
                                       stub=(plan.stub == "resolve"))

    # ---- sun shadow raster (T4; back-face cull, sun_shadow_draw.inl)
    shadow_map = None
    overflow = vis.overflow
    if cfg.enable_shadows and not plan.shadow_statically_empty:
        sclip = _clip_of(world, g.sun.projection_view)
        # depth_only: the sun shadow view only ever consumes depth
        # (sun_shadow_draw.inl writes D32 only) — the id-free resolve
        # kernel skips winner tracking and half the write-back
        svis, _ = raster2.rasterize(sclip, plan.shadow_grid, cull="back",
                                    interpret=plan.interpret, shard=shard,
                                    stub=(plan.stub == "shadow_resolve"),
                                    depth_only=True)
        shadow_map = svis.depth
        overflow = overflow | svis.overflow

    records = gbuf_ops.build_shading_records(
        setup, world, wnrm, batch.tri_uv, batch.static_rows,
        pack=plan.rec_pack)
    return vis, records, shadow_map, overflow


def _row_pin(plan: FramePlan):
    """Returns f(x): pin an image (or pytree of images) to rows split
    over plan.shard_axis — identity when no mesh is configured.  Arrays
    whose second-to-last dim is the row axis ((H, W) and (C, H, W))
    are constrained; scalars and pyramid levels below the shard count
    pass through."""
    if plan.shard_mesh is None or plan.shard_axis is None:
        return lambda x: x
    from jax.sharding import NamedSharding, PartitionSpec as P
    mesh = plan.shard_mesh
    n = mesh.shape[plan.shard_axis]

    def pin(x):
        def one(a):
            if getattr(a, "ndim", 0) < 2 or a.shape[-2] % n != 0:
                return a
            spec = P(*([None] * (a.ndim - 2) + [plan.shard_axis, None]))
            return jax.lax.with_sharding_constraint(
                a, NamedSharding(mesh, spec))
        return jax.tree_util.tree_map(one, x)

    return pin


def shade_stage(plan: FramePlan, batch: SceneBatch, g: ShaderGlobals,
                history: RenderHistory, vis, records, shadow_map,
                overflow) -> tuple[FrameOutputs, RenderHistory]:
    """Screen-space half of the frame (T2/T3 + T6-fragment + T9-T20),
    all plain XLA: under a mesh the SPMD partitioner shards every pass
    by the row layout _row_pin sets."""
    cfg = plan.config
    rows = _row_pin(plan)
    if plan.vis_barrier:
        vis = dataclasses.replace(
            vis, depth=jax.lax.optimization_barrier(vis.depth),
            tri_id=jax.lax.optimization_barrier(vis.tri_id))
    vis = dataclasses.replace(vis, depth=rows(vis.depth),
                              tri_id=rows(vis.tri_id))
    shadow_map = rows(shadow_map) if shadow_map is not None else None
    # ---- Min/Max HiZ pyramids (T2/T3, renderer.cpp:988-1001): the
    # reference dispatches both every frame even though nothing reads
    # them (SSR declares-but-ignores); computed here for parity and
    # exported for debug/SSR extensions.
    hiz_min = hiz_max = None
    if cfg.enable_hiz:
        from ..ops import hiz as hiz_ops
        hiz_min = hiz_ops.build_hiz(vis.depth, "min")
        hiz_max = hiz_ops.build_hiz(vis.depth, "max")

    # ---- deferred G-buffer resolve (T6 fragment semantics)
    gbuf = gbuf_ops.resolve_gbuffer(
        vis, records, batch.atlas_packed, g.camera_prev.projection_view,
        atlas_size=plan.atlas_size, layer_stride=plan.atlas_layer_stride,
        n_levels=plan.atlas_n_levels, filter_mode=plan.texture_filter,
        stub_records=(plan.stub == "records"))
    # materialize the G-buffer targets that downstream passes consume
    # through shifts/resamples: without the barrier XLA fuses the whole
    # G-buffer math into each consumer tap and RECOMPUTES it per tap
    # (the render-target boundary is semantic on a GPU, explicit here)
    gbuf = jax.tree_util.tree_map(jax.lax.optimization_barrier, gbuf)
    gbuf = rows(gbuf)

    # ---- bloom (T14/T15) on the emissive target before composition
    emissive = gbuf.emissive
    bloom = None
    if cfg.enable_bloom:
        emissive = bloom_ops.bloom(emissive, cfg.bloom_mip_count)
        bloom = emissive

    # ---- SSAO + blur (T9/T10), half resolution
    ssao = None
    if cfg.enable_ssao:
        ssao = ssao_ops.ssao_blur(ssao_ops.ssao_generate(
            vis.depth, gbuf.normal, g, cfg.ssao_kernel_size))
        # composition samples the half-res target bilinearly at full res
        ssao_full = sampling.upsample_bilinear(ssao, cfg.height, cfg.width)
    else:
        ssao_full = jnp.ones_like(vis.depth)

    # ---- SSR (T11; computed but not composited by default, like the
    # reference's commented-out mix)
    ssr_img = None
    ssr_active = jnp.int32(-1)
    if cfg.enable_ssr:
        ssr_img, ssr_overflow, ssr_active = ssr_ops.ssr(
            vis.depth, gbuf.albedo, gbuf.normal,
            gbuf.metallic_roughness, g, compact_cap=plan.ssr_cap)
        overflow = overflow | ssr_overflow

    # ---- clouds + atmosphere (T12): sky LUT march (gather-free
    # procedural noise) + per-pixel directional lookup at half res
    clouds_full = None
    clouds_half = None
    if cfg.enable_clouds:
        hw, hh = cfg.width // 2, cfg.height // 2
        if cfg.cloud_noise_mode == "texture" and batch.cloud_noise is None:
            # requested the real-noise texture but the asset is missing:
            # outputs change shape class (procedural value noise), so
            # say so once per trace (ADVICE round 2)
            import warnings
            warnings.warn(
                "cloud_noise_mode='texture' falling back to the "
                "procedural sky LUT: batch.cloud_noise is missing; "
                "cloud shapes will differ from the reference noise "
                "texture.", stacklevel=2)
        lut = None
        if cfg.cloud_impl == "perpixel" and batch.cloud_noise is None:
            # a parity/benchmark run asking for the exact per-pixel
            # march must not silently measure the LUT algorithm instead
            # (ADVICE r4), mirroring the procedural-LUT warning above
            import warnings
            warnings.warn(
                "cloud_impl='perpixel' falling back to the sky-LUT "
                "path: batch.cloud_noise is missing — the exact "
                "per-pixel march needs the noise texture.",
                stacklevel=2)
        if (cfg.cloud_impl == "perpixel"
                and batch.cloud_noise is not None):
            # the reference's exact per-pixel march (T12,
            # cloud_rendering.inl:461, 92-113) — parity/offline mode;
            # the LUT default's deviation from this is quantified in
            # PARITY.md (mean <= 0.31%)
            clouds_half = clouds_ops.render_clouds(
                g, vis.depth, batch.cloud_noise, hw, hh,
                full_width=None if cfg.cloud_fullscreen_rays
                else cfg.width,
                full_height=None if cfg.cloud_fullscreen_rays
                else cfg.height)
        elif cfg.cloud_noise_mode == "texture" \
                and batch.cloud_noise is not None:
            # the real noise texture, sampled by the gather-based
            # _sample_repeat (reference cloud shapes)
            lut = clouds_ops.render_sky_lut(g,
                                            noise_tex=batch.cloud_noise)
        else:
            lut = clouds_ops.render_sky_lut(g)
        if lut is not None:
            # QUADRANT quirk (config.cloud_fullscreen_rays docstring):
            # pass the FULL resolution so the half-res rays/sky-mask
            # span only the top-left frustum quadrant like the reference
            clouds_half = clouds_ops.sky_from_lut(
                g, lut, vis.depth, hw, hh,
                full_width=None if cfg.cloud_fullscreen_rays
                else cfg.width,
                full_height=None if cfg.cloud_fullscreen_rays
                else cfg.height)
        clouds_full = sampling.upsample_bilinear(clouds_half, cfg.height,
                                                 cfg.width)

    # ---- composition (T13)
    if plan.stub == "unlit":
        # attribution stub: albedo passthrough instead of lighting;
        # composition-only inputs stay live via a non-foldable epsilon
        # so their producing passes aren't dead-code-eliminated
        eps = ssao_full.sum() * 1e-30
        if clouds_full is not None:
            eps = eps + clouds_full.sum() * 1e-30
        if shadow_map is not None:
            eps = eps + shadow_map.sum() * 1e-30
        hdr = gbuf.albedo + eps
    else:
        hdr = comp_ops.compose(
            g, vis.depth, gbuf.albedo, emissive, gbuf.normal, ssao_full,
            shadow_map, clouds_full,
            enable_volumetric=cfg.enable_volumetric_light,
            enable_shadow=cfg.enable_shadows,
            max_point_lights=cfg.max_point_lights,
            max_spot_lights=cfg.max_spot_lights,
            empty_shadow_map=(cfg.enable_shadows
                              and plan.shadow_statically_empty),
            shadow_crop=plan.shadow_crop)
    # render-target barrier: TAA shifts hdr 9 ways and the histogram
    # reduces it — fused recompute of composition per consumer is the
    # dominant glue cost otherwise
    hdr = rows(jax.lax.optimization_barrier(hdr))
    if cfg.composite_ssr and ssr_img is not None:
        # the mix the reference comments out (composition.inl:213-216)
        rough = gbuf.metallic_roughness[0]
        metal = gbuf.metallic_roughness[1]
        wgt = (metal * (1.0 - rough))[None]
        hdr = hdr + (ssr_img - hdr) * wgt

    # ---- depth of field (T21; disabled in the reference graph).  The
    # reference's commented task chain (renderer.cpp:1119-1153) blits
    # the post-composition HDR color, mips it and blurs back into
    # color_image BEFORE the luminance histogram and TAA — so when
    # enabled, DoF feeds exposure/TAA and the TAA history, rather than
    # post-processing the resolved frame.  (Previously this ran after
    # TAA and leaked into previous_color, compounding blur every
    # frame.)
    if cfg.enable_depth_of_field:
        from ..ops import dof as dof_ops
        hdr = dof_ops.depth_of_field(hdr, vis.depth, g)

    # ---- auto exposure (T16/T17)
    if cfg.enable_auto_exposure:
        exposure = exposure_ops.auto_exposure(hdr, history.exposure, g)
    else:
        exposure = history.exposure

    # ---- TAA (T18) + history copy (T19 -> carry)
    velocity = gbuf.velocity
    if cfg.enable_taa:
        resolved = taa_ops.taa(hdr, vis.depth, velocity,
                               history.previous_color,
                               history.previous_velocity,
                               g.frame_counter)
    else:
        resolved = hdr

    # ---- tone mapping (T20)
    resolved = rows(resolved)
    color = rows(tonemap_ops.tone_map(resolved, exposure, g))

    new_history = RenderHistory(
        previous_color=resolved.astype(jnp.bfloat16),
        previous_velocity=velocity.astype(jnp.bfloat16),
        exposure=exposure,
    )
    outputs = FrameOutputs(color=color, hdr=hdr, gbuffer=gbuf,
                           shadow_map=shadow_map, ssao=ssao,
                           clouds=clouds_half, bloom=bloom, ssr=ssr_img,
                           hiz_min=hiz_min, hiz_max=hiz_max,
                           overflow=overflow, ssr_active=ssr_active)
    return outputs, new_history


def render_frame(plan: FramePlan, batch: SceneBatch, g: ShaderGlobals,
                 history: RenderHistory,
                 model_mats, normal_mats) -> tuple[FrameOutputs, RenderHistory]:
    """One frame. All array args are traced; `plan` is static."""
    check_sun_proof(plan, g)
    check_shadow_crop(plan, model_mats)
    vis, records, shadow_map, overflow = raster_stage(
        plan, batch, g, model_mats, normal_mats)
    return shade_stage(plan, batch, g, history, vis, records, shadow_map,
                       overflow)


def check_sun_proof(plan: FramePlan, g: ShaderGlobals):
    """Raise if `plan` elides the sun shadow pass but `g` carries a sun
    the emptiness proof was not run against (ADVICE round 2: the proof
    is baked at scene build; an arbitrary caller-supplied sun must not
    silently inherit it)."""
    if not plan.shadow_statically_empty or plan.proved_sun_pv is None:
        return
    pv = g.sun.projection_view
    if isinstance(pv, jax.core.Tracer):
        # Traced (inside jit/vmap): values are unavailable, so the
        # check must happen host-side BEFORE dispatch.  Both jit entry
        # points do this — make_render_fn's `checked` wrapper and
        # parallel.mesh.make_batched_render_fn's (which passes the
        # batched (B, 4, 4) projection_view; allclose broadcasts).
        # Anyone jitting render_frame directly must call
        # check_sun_proof themselves or forgo elision.
        return
    import numpy as np
    proved = np.asarray(plan.proved_sun_pv, np.float32).reshape(4, 4)
    if not np.allclose(np.asarray(pv), proved, atol=1e-6):
        raise ValueError(
            "FramePlan.shadow_statically_empty was proved for a different "
            "sun projection_view than this frame's g.sun. Rebuild the "
            "scene plan for the new sun (scenes._finish re-runs the "
            "proof) or set shadow_statically_empty=False.")


def check_shadow_crop(plan: FramePlan, model_mats):
    """Raise if `plan` carries a shadow sampling crop proved for
    DIFFERENT model matrices than this frame's (ADVICE r4): the crop is
    sound only for the geometry placement it was proved against —
    moved geometry outside a stale crop would silently lose its shadow.
    Traced calls pass through (host-side entry points check pre-jit,
    same contract as check_sun_proof)."""
    if plan.shadow_crop is None or plan.proved_crop_mats is None:
        return
    if isinstance(model_mats, jax.core.Tracer):
        return
    import numpy as np
    proved = np.asarray(plan.proved_crop_mats, np.float32)
    mm = np.asarray(model_mats, np.float32).ravel()
    if mm.shape != proved.shape or not np.allclose(mm, proved, atol=1e-6):
        raise ValueError(
            "FramePlan.shadow_crop was proved for different model "
            "matrices than this frame's. Rebuild the scene plan "
            "(BuiltScene.rebuild re-proves the crop) or set "
            "shadow_crop=None to sample the full map.")


def bench_probe(out: FrameOutputs) -> jax.Array:
    """Reduced per-frame probe for the benchmark harnesses (bench.py,
    tools/bench_baselines.py, tools/bench_toggle.py).

    Probe-liveness rule (VERDICT r3 item 2): XLA dead-code-eliminates
    backwards from the scan output, so a bench that reads only
    ``color`` silently measures a frame WITHOUT any pass that does not
    feed color.  Every FrameOutputs field that can be computed without
    being composited must therefore contribute to the probe:

    * the HiZ pyramids — the reference builds them every frame and
      nothing reads them (SSR declares-but-ignores, T2/T3);
    * SSR when ``composite_ssr`` is off — the reference runs the
      50-iteration march and comments out the mix
      (``composition.inl:213-216``), so the march's cost is real and
      must stay live in the measured frame.

    Any future computed-but-not-composited pass must be added here.
    """
    probe = out.color[:, ::64, ::64].sum()
    if out.hiz_min is not None:
        probe = probe + out.hiz_min[-1].sum() + out.hiz_max[-1].sum()
    if out.ssr is not None:
        probe = probe + out.ssr[:, ::64, ::64].astype(jnp.float32).sum()
    return probe


@functools.lru_cache(maxsize=8)
def make_render_fn(plan: FramePlan):
    """Jitted frame function with history donated (the frames-in-flight
    ring buffer analog: TAA/exposure state updates in place).

    Memoized on the (hashable, frozen) plan: callers that re-derive
    their plan per edit/rebuild (ui/server.render_loop) get the SAME
    jitted callable back for an unchanged plan, so no re-trace happens
    unless the plan really changed.

    The wrapper validates g.sun against the shadow-elision proof before
    dispatch (16-float host compare; see check_sun_proof)."""
    f = jax.jit(functools.partial(render_frame, plan),
                donate_argnames=("history",))
    if not plan.shadow_statically_empty and plan.shadow_crop is None:
        return f

    def checked(batch, g, history, model_mats, normal_mats):
        check_sun_proof(plan, g)
        check_shadow_crop(plan, model_mats)
        return f(batch, g, history, model_mats, normal_mats)

    return checked
