"""Scene flattening: ECS scene -> device-resident batched arrays.

The reference draws per-entity, per-primitive with push constants
(``g_buffer_generation.inl:111-144``); this build merges the whole
scene into one batch so a single rasterizer invocation covers
everything:

* vertex attributes are **pre-expanded per triangle** at load time
  ((T, 3, ...) layouts) so the per-frame path has zero vertex gathers —
  the index buffer disappears after load;
* the four material textures are packed into ONE (16, N) uint8 atlas
  (models/texture.pack_material_atlas), then bilinear-expanded to
  (N, 12) int32 rows (expand_atlas_bilinear) so a full bilinear texture
  tap is ONE gather;
* per-triangle static shading constants (material id + has-flags) ride
  in a (5, T) row block concatenated into the per-frame G-buffer record
  (ops/gbuffer.py).

Giant world-space triangles are pre-split at load so the rasterizer's
bounded bin expansion never truncates (ops/raster2.py docstring).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import jax
import numpy as np

from .gltf import ModelData
from .texture import PackedMaterialAtlas, decode_images_parallel, \
    expand_atlas_bilinear, \
    pack_material_atlas


def _pytree(cls):
    jax.tree_util.register_dataclass(
        cls, data_fields=[f.name for f in dataclasses.fields(cls)],
        meta_fields=[])
    return cls


@_pytree
@dataclass(frozen=True)
class SceneBatch:
    """Merged triangle-expanded scene geometry (static across frames)."""
    tri_pos: jax.Array       # (3 verts, 3 xyz, T) f32 object space (planar:
    #                           T on the last axis)
    tri_nrm: jax.Array       # (3, 3, T) f32 object-space vertex normals
    tri_uv: jax.Array        # (3 verts, 2, T) f32
    tri_entity: jax.Array    # (T,) i32 mesh-entity index
    static_rows: jax.Array   # (5, T) f32: [material_id, has_normal,
    #                           has_metallic_roughness, has_emissive,
    #                           is_terrain]
    atlas_packed: jax.Array  # (M * layer_stride, 12) int32 row-major:
    #                           11 sampled channels x 4 u32-packed
    #                           bilinear corners per texel row
    #                           (texture.expand_atlas_bilinear)
    cloud_noise: jax.Array | None = None  # (64, 64) f32 tiled cloud noise
    #                           (assets/Clouds/noise.png R channel,
    #                           cloud_rendering.inl:219-233); None falls
    #                           back to the procedural sky LUT

    @property
    def num_triangles(self):
        return self.tri_pos.shape[2]


def split_large_triangles(pos, nrm, uv, ent, mat, max_extent: float,
                          max_rounds: int = 4):
    """Midpoint-split triangles whose bbox extent exceeds max_extent
    (world units).  Keeps the raster bin expansion bounded."""
    for _ in range(max_rounds):
        ext = (pos.max(axis=1) - pos.min(axis=1)).max(axis=-1)
        big = ext > max_extent
        if not big.any():
            break
        keep = ~big
        bp, bn, bu = pos[big], nrm[big], uv[big]
        be, bm = ent[big], mat[big]
        # split at longest-edge midpoint into 2 triangles
        e0 = np.linalg.norm(bp[:, 1] - bp[:, 0], axis=-1)
        e1 = np.linalg.norm(bp[:, 2] - bp[:, 1], axis=-1)
        e2 = np.linalg.norm(bp[:, 0] - bp[:, 2], axis=-1)
        longest = np.argmax(np.stack([e0, e1, e2], -1), axis=-1)

        def mid(a, b):
            return (a + b) * 0.5

        new_p, new_n, new_u = [], [], []
        for arr, out in ((bp, new_p), (bn, new_n), (bu, new_u)):
            a, b, c = arr[:, 0], arr[:, 1], arr[:, 2]
            m01, m12, m20 = mid(a, b), mid(b, c), mid(c, a)
            # longest==0: split edge ab -> (a,m,c), (m,b,c); etc.
            t1 = np.where(longest[:, None, None] == 0,
                          np.stack([a, m01, c], 1),
                          np.where(longest[:, None, None] == 1,
                                   np.stack([a, b, m12], 1),
                                   np.stack([a, b, m20], 1)))
            t2 = np.where(longest[:, None, None] == 0,
                          np.stack([m01, b, c], 1),
                          np.where(longest[:, None, None] == 1,
                                   np.stack([a, m12, c], 1),
                                   np.stack([m20, b, c], 1)))
            out.append(np.concatenate([t1, t2]))
        pos = np.concatenate([pos[keep], new_p[0]])
        nrm = np.concatenate([nrm[keep], new_n[0]])
        uv = np.concatenate([uv[keep], new_u[0]])
        ent = np.concatenate([ent[keep], be, be])
        mat = np.concatenate([mat[keep], bm, bm])
    return pos, nrm, uv, ent, mat


def build_scene_batch(models: list[ModelData], atlas_size: int = 1024,
                      workers: int = 8, split_extent_frac: float = 0.125,
                      ) -> tuple[SceneBatch, PackedMaterialAtlas]:
    """models[i] belongs to mesh-entity i (creation order)."""
    all_materials, all_images, mat_offsets = [], [], []
    for m in models:
        mat_offsets.append(len(all_materials))
        img_off = len(all_images)
        all_images.extend(m.images)
        for md in m.materials:
            md2 = dataclasses.replace(
                md,
                albedo_image=md.albedo_image + img_off if md.albedo_image >= 0 else -1,
                metallic_roughness_image=md.metallic_roughness_image + img_off
                if md.metallic_roughness_image >= 0 else -1,
                normal_image=md.normal_image + img_off if md.normal_image >= 0 else -1,
                occlusion_image=md.occlusion_image + img_off if md.occlusion_image >= 0 else -1,
                emissive_image=md.emissive_image + img_off if md.emissive_image >= 0 else -1,
            )
            all_materials.append(md2)

    decoded = decode_images_parallel([r.data for r in all_images], workers)
    atlas = pack_material_atlas(all_materials, decoded, size=atlas_size,
                                workers=workers)

    pos_l, nrm_l, uv_l, ent_l, mat_l, ter_l = [], [], [], [], [], []
    for ei, (m, moff) in enumerate(zip(models, mat_offsets)):
        tris = m.triangles.astype(np.int64)
        pos_l.append(m.positions[tris])
        nrm_l.append(m.normals[tris])
        uv_l.append(m.uvs[tris])
        ent_l.append(np.full(len(tris), ei, np.int32))
        mat_l.append(m.tri_material.astype(np.int32) + moff)
        ter_l.append(np.full(len(tris), 1.0 if m.terrain else 0.0,
                             np.float32))

    pos = np.concatenate(pos_l).astype(np.float32)
    nrm = np.concatenate(nrm_l).astype(np.float32)
    uv = np.concatenate(uv_l).astype(np.float32)
    ent = np.concatenate(ent_l)
    mat = np.concatenate(mat_l)
    ter = np.concatenate(ter_l)

    if split_extent_frac:
        scene_ext = float((pos.reshape(-1, 3).max(0)
                           - pos.reshape(-1, 3).min(0)).max())
        pos, nrm, uv, ent, matter = split_large_triangles(
            pos, nrm, uv, ent, np.stack([mat.astype(np.float32), ter], -1),
            scene_ext * split_extent_frac)
        mat = matter[:, 0].astype(np.int32)
        ter = matter[:, 1]

    # lookup tables indexed by per-tri material id
    def flag(attr):
        tbl = np.array([1.0 if getattr(mm, attr) >= 0 else 0.0
                        for mm in all_materials], np.float32)
        return tbl[mat]

    has = np.stack([
        mat.astype(np.float32),
        flag("normal_image"),
        flag("metallic_roughness_image"),
        flag("emissive_image"),
        ter,
    ], axis=0)

    batch = SceneBatch(
        tri_pos=np.ascontiguousarray(pos.transpose(1, 2, 0)),
        tri_nrm=np.ascontiguousarray(nrm.transpose(1, 2, 0)),
        tri_uv=np.ascontiguousarray(uv.transpose(1, 2, 0)),
        tri_entity=ent, static_rows=has,
        atlas_packed=expand_atlas_bilinear(atlas),
    )
    return batch, atlas
