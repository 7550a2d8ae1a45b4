"""Configuration & per-frame globals.

The reference keeps one big ``ShaderGlobals`` uniform block that every
shader reads (``/root/reference/src/graphics/shared.inl:47-133``), filled
with startup defaults (``renderer.cpp:72-133``) and mutated live by ImGui
sliders (``renderer.cpp:683-767``).  This build splits it into:

* :class:`RenderConfig` — *static* (hashable) configuration: resolution,
  pass toggles, kernel tile sizes.  Changing one triggers a re-jit, like
  rebuilding pipelines in the reference.
* :class:`ShaderGlobals` — *dynamic* pytree of per-frame values (camera
  matrices, jitter, light arrays, tunable parameters).  These are plain
  traced leaves of the jitted frame function, so they can change every
  frame without recompilation — the uniform-ring-buffer analog.

Defaults mirror ``renderer.cpp:72-133`` exactly.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import jax
import numpy as np

from .utils import mathutil as mu

MAX_POINT_LIGHTS = 128  # shared.inl:84
MAX_SPOT_LIGHTS = 128   # shared.inl:85
AUTO_EXPOSURE_BIN_COUNT = 256  # shared.inl:38


def _pytree_dataclass(cls):
    """Register a frozen dataclass whose fields are all data leaves."""
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


def _f32(x):
    return np.asarray(x, dtype=np.float32)


@_pytree_dataclass
@dataclass(frozen=True)
class CameraMatrices:
    """One camera matrix set (the 6-matrix block in ShaderGlobals,
    shared.inl:48-60, written by application.cpp:148-159)."""
    projection: jax.Array        # (4,4) jittered projection
    inv_projection: jax.Array
    view: jax.Array
    inv_view: jax.Array
    projection_view: jax.Array
    inv_projection_view: jax.Array
    position: jax.Array          # (3,)
    jitter: jax.Array            # (2,) ndc-space jitter actually applied

    @staticmethod
    def from_proj_view(proj: np.ndarray, view: np.ndarray, position,
                       jitter=(0.0, 0.0)):
        proj = _f32(proj)
        view = _f32(view)
        inv_p = np.linalg.inv(proj).astype(np.float32)
        inv_v = np.linalg.inv(view).astype(np.float32)
        return CameraMatrices(
            projection=proj,
            inv_projection=inv_p,
            view=view,
            inv_view=inv_v,
            projection_view=(proj @ view).astype(np.float32),
            # NOTE: the reference computes inverse_projection_view as
            # inv(P) * inv(V) (application.cpp:138) which is inv(V*P), a
            # bug — the shaders never read it, so we store the correct
            # inv(P*V).
            inv_projection_view=np.linalg.inv(proj @ view).astype(np.float32),
            position=_f32(position),
            jitter=_f32(jitter),
        )


@_pytree_dataclass
@dataclass(frozen=True)
class SunInfo:
    """Sun/shadow parameters (shared.inl:24-37, defaults renderer.cpp:104-133)."""
    projection: jax.Array        # (4,4) ortho +-16 (renderer.cpp:110-112)
    view: jax.Array              # (4,4) lookAt(light_pos, pos+dir, (0,-1,0))
    projection_view: jax.Array
    terrain_y_clip_trick: jax.Array  # (4,) P*V*(0,1,0,0)
    position: jax.Array          # (3,) default (-3.2, 40, -4)
    direction: jax.Array         # (3,)
    exponential_factor: jax.Array  # -80.0
    darkening_factor: jax.Array    # 1.0
    bias: jax.Array                # 1e-4
    intensity: jax.Array           # 1.0

    @staticmethod
    def create(angle_direction_deg=(4.0, 0.0, 0.0),
               position=(-3.2, 40.0, -4.0), planes=16.0,
               exponential_factor=-80.0, darkening_factor=1.0,
               bias=1e-4, intensity=1.0):
        """Mirrors renderer.cpp:108-133 (angle default renderer.hpp:67)."""
        d = np.array([0.0, -1.0, 0.0], np.float32)
        d = mu.rotate_x(d, np.radians(angle_direction_deg[0]))
        d = mu.rotate_y(d, np.radians(angle_direction_deg[1]))
        d = mu.rotate_z(d, np.radians(angle_direction_deg[2]))
        proj = mu.orthographic(-planes, planes, -planes, planes, -planes, planes)
        pos = _f32(position)
        view = mu.look_at(pos, pos + d, np.array([0.0, -1.0, 0.0], np.float32))
        pv = (proj @ view).astype(np.float32)
        trick = pv @ np.array([0.0, 1.0, 0.0, 0.0], np.float32)
        return SunInfo(
            projection=proj, view=view, projection_view=pv,
            terrain_y_clip_trick=_f32(trick), position=pos, direction=_f32(d),
            exponential_factor=_f32(exponential_factor),
            darkening_factor=_f32(darkening_factor),
            bias=_f32(bias), intensity=_f32(intensity),
        )


@_pytree_dataclass
@dataclass(frozen=True)
class LightArrays:
    """Fixed-capacity light arrays (shared.inl:82-85; gathered by
    Scene::update, scene.cpp:85-117).  Struct-of-arrays layout."""
    point_position: jax.Array   # (128, 3)
    point_color: jax.Array      # (128, 3)
    point_intensity: jax.Array  # (128,)
    point_count: jax.Array      # () int32
    spot_position: jax.Array    # (128, 3)
    spot_direction: jax.Array   # (128, 3)
    spot_color: jax.Array       # (128, 3)
    spot_intensity: jax.Array   # (128,)
    spot_cut_off: jax.Array     # (128,) cos(inner)
    spot_outer_cut_off: jax.Array  # (128,) cos(outer)
    spot_count: jax.Array       # () int32

    @staticmethod
    def empty():
        z3 = np.zeros((MAX_POINT_LIGHTS, 3), np.float32)
        z1 = np.zeros((MAX_POINT_LIGHTS,), np.float32)
        return LightArrays(
            point_position=z3, point_color=z3, point_intensity=z1,
            point_count=np.int32(0),
            spot_position=z3, spot_direction=z3, spot_color=z3,
            spot_intensity=z1, spot_cut_off=z1, spot_outer_cut_off=z1,
            spot_count=np.int32(0),
        )


@_pytree_dataclass
@dataclass(frozen=True)
class ShaderGlobals:
    """Dynamic per-frame globals — the analog of the uniform block
    shared.inl:47-133.  Every parameter an ImGui slider could touch in
    the reference is a traced leaf here."""
    camera: CameraMatrices
    camera_prev: CameraMatrices
    camera_near_clip: jax.Array
    camera_far_clip: jax.Array
    elapsed_time: jax.Array
    delta_time: jax.Array
    frame_counter: jax.Array     # () int32

    sun: SunInfo
    lights: LightArrays

    # terrain (renderer.cpp:72-80)
    terrain_offset: jax.Array        # (3,) (0,0,0)
    terrain_scale: jax.Array         # (2,) (100,100)
    terrain_height_scale: jax.Array  # 70.0
    terrain_midpoint: jax.Array      # 0.2
    terrain_delta: jax.Array         # 8.0
    terrain_min_depth: jax.Array     # 1.0
    terrain_max_depth: jax.Array     # 100.0
    terrain_y_clip_trick: jax.Array          # (4,)
    terrain_previous_y_clip_trick: jax.Array  # (4,)

    # bloom
    filter_radius: jax.Array         # 0.0 default (never set in ref ctor)

    # ssao (renderer.cpp:83-85)
    ssao_bias: jax.Array             # 0.025
    ssao_radius: jax.Array           # 0.3

    # composition (renderer.cpp:87-89)
    ambient: jax.Array               # (3,) (0.1,0.1,0.1)
    ambient_occlussion_strength: jax.Array  # 1.2 (sic, reference spelling)
    emissive_bloom_strength: jax.Array      # 2.0

    # depth of field (renderer.cpp:91-93)
    focal_length: jax.Array          # 5.0
    plane_in_focus: jax.Array        # 1.0
    aperture: jax.Array              # 8.0

    # auto exposure (renderer.cpp:95-102)
    adjustment_speed: jax.Array      # 1.0
    log_min_luminance: jax.Array     # remapped, see create()
    log_max_luminance: jax.Array
    target_luminance: jax.Array      # 0.2140

    # tone mapping (renderer.cpp:104-107)
    saturation: jax.Array            # 1.0
    agx_ds_linear_section: jax.Array  # 0.18
    peak: jax.Array                  # 1.0
    compression: jax.Array           # 0.15

    @staticmethod
    def create(camera: CameraMatrices | None = None,
               camera_prev: CameraMatrices | None = None,
               sun: SunInfo | None = None,
               lights: LightArrays | None = None,
               near_clip=0.1, far_clip=1000.0, **overrides):
        """Defaults exactly as renderer.cpp:72-133."""
        ident = CameraMatrices.from_proj_view(np.eye(4), np.eye(4), (0, 0, 0))
        camera = camera if camera is not None else ident
        camera_prev = camera_prev if camera_prev is not None else camera
        sun = sun if sun is not None else SunInfo.create()
        lights = lights if lights is not None else LightArrays.empty()
        target_luminance = 0.2140
        # renderer.cpp:100-102: log bounds remapped through the target.
        log_min = np.log2(target_luminance / np.exp2(-15.0))
        log_max = np.log2(target_luminance / np.exp2(15.0))
        vals = dict(
            camera=camera, camera_prev=camera_prev,
            camera_near_clip=_f32(near_clip), camera_far_clip=_f32(far_clip),
            elapsed_time=_f32(0.0), delta_time=_f32(1.0 / 60.0),
            frame_counter=np.int32(0),
            sun=sun, lights=lights,
            terrain_offset=_f32([0.0, 0.0, 0.0]),
            terrain_scale=_f32([100.0, 100.0]),
            terrain_height_scale=_f32(70.0),
            terrain_midpoint=_f32(0.2),
            terrain_delta=_f32(8.0),
            terrain_min_depth=_f32(1.0),
            terrain_max_depth=_f32(100.0),
            terrain_y_clip_trick=_f32(sun.terrain_y_clip_trick),
            terrain_previous_y_clip_trick=_f32(sun.terrain_y_clip_trick),
            filter_radius=_f32(0.005),
            ssao_bias=_f32(0.025), ssao_radius=_f32(0.3),
            ambient=_f32([0.1, 0.1, 0.1]),
            ambient_occlussion_strength=_f32(1.2),
            emissive_bloom_strength=_f32(2.0),
            focal_length=_f32(5.0), plane_in_focus=_f32(1.0),
            aperture=_f32(8.0),
            adjustment_speed=_f32(1.0),
            log_min_luminance=_f32(log_min),
            log_max_luminance=_f32(log_max),
            target_luminance=_f32(target_luminance),
            saturation=_f32(1.0), agx_ds_linear_section=_f32(0.18),
            peak=_f32(1.0), compression=_f32(0.15),
        )
        vals.update(overrides)
        return ShaderGlobals(**vals)


@dataclass(frozen=True)
class RenderConfig:
    """Static render configuration — the jit-compile-time half.

    Covers what the reference fixes at pipeline/framebuffer build time:
    resolution (renderer.cpp:820-881), half-res SSAO/clouds
    (renderer.cpp:827-831), 4096^2 shadow map (renderer.cpp:38-70),
    bloom mip count (renderer.cpp:492-513), SSAO kernel size
    (ssao_generation.inl:74-103), pass toggles (the reference's
    commented-out DoF/SSR-composite/display passes).
    """
    width: int = 1280
    height: int = 720
    shadow_resolution: int = 4096
    bloom_mip_count: int = 4
    ssao_kernel_size: int = 26
    half_res_ssao: bool = True
    half_res_clouds: bool = True
    # Pass toggles (reference defaults: DoF & display disabled, SSR
    # computed but not composited, volumetric light zeroed).
    enable_shadows: bool = True
    enable_hiz: bool = True  # Min/Max HiZ pyramids every frame, parity
    #                          with renderer.cpp:988-1001 (their only
    #                          declared consumer, SSR, never reads them
    #                          — screen_space_reflection.inl:17-18)
    enable_terrain: bool = False
    enable_ssao: bool = True
    enable_ssr: bool = False  # op exists; reference computes-but-never-uses it
    #                           (composition.inl:213-216) — off saves 50-step
    #                           marches of dead work
    composite_ssr: bool = False         # composition.inl:213-216 commented out
    enable_clouds: bool = True
    # Sky noise source: "texture" = the LUT samples the real
    # assets/Clouds/noise.png (reference cloud shapes,
    # cloud_rendering.inl:219-233) when the scene has it; "procedural"
    # = hash value noise (gather-free; shapes differ statistically).
    cloud_noise_mode: str = "texture"
    # Cloud algorithm: "lut" (default) marches the 256x128 directional
    # sky LUT once per frame and looks it up per pixel (measured error
    # vs the exact march: mean <= 0.31%, worst <= 4.1% — PARITY.md);
    # "perpixel" runs the reference's per-pixel 24x10 march
    # (cloud_rendering.inl:461, 92-113) at half res — the exact
    # algorithm, ~2112 noise taps per pixel, for parity verification
    # and offline renders (orders of magnitude slower than the LUT).
    cloud_impl: str = "lut"
    # Reference QUADRANT quirk (kept by default): the half-res cloud
    # pass divides its pixel coordinate by the FULL window resolution
    # (cloud_rendering.inl:443-445 with renderer.cpp:829-831's
    # half-size image), so sky rays + the depth sky-mask span only the
    # top-left frustum quadrant, stretched fullscreen by composition
    # (composition.inl:221).  True = corrected fullscreen ray span.
    cloud_fullscreen_rays: bool = False
    enable_bloom: bool = True
    enable_taa: bool = True
    enable_auto_exposure: bool = True
    enable_depth_of_field: bool = False  # renderer.cpp:1119-1153 commented out
    enable_volumetric_light: bool = False  # composition.inl:196 force-zeroed
    # Static light-scan bounds (the 128-slot arrays always exist for
    # ABI parity; scenes with fewer lights compile shorter scans).
    max_point_lights: int = 128
    max_spot_lights: int = 128
    # Terrain grid (100x100 patches, renderer.cpp:214-247) subdivided on
    # host because the software raster has no tessellation stage; this
    # factor plays the role of the uniform tess level
    # (draw_terrain.inl:152-159).
    terrain_patches: int = 100
    terrain_subdiv: int = 2

    @property
    def resolution(self):
        return (self.width, self.height)

    @property
    def half_resolution(self):
        return (self.width // 2, self.height // 2)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def plastic_jitter(index, width, height):
    """TAA sub-pixel jitter — plastic-number low-discrepancy sequence,
    exactly application.cpp:113-127: g = 1.32471795724474602596,
    a1 = 1/g, a2 = 1/g^2, jitter = (mod(0.5 + a*(i+1), 1) - 0.5) / res,
    index cycling mod 32.

    Works on python ints or traced int32. Returns jitter in NDC units
    (i.e. the value added to proj[0,3]/proj[1,3]).
    """
    import jax.numpy as jnp
    g = 1.32471795724474602596
    a1 = np.float32(1.0 / g)
    a2 = np.float32(1.0 / (g * g))
    i = (jnp.asarray(index, jnp.int32) % 32).astype(jnp.float32)
    jx = jnp.mod(0.5 + a1 * (i + 1.0), 1.0) - 0.5
    jy = jnp.mod(0.5 + a2 * (i + 1.0), 1.0) - 0.5
    return jnp.stack([jx / width, jy / height]).astype(jnp.float32)
