"""Multi-device rendering: device meshes + shardings.

The reference is single-GPU (SURVEY.md §2.6); the scaling model here is
SPMD over a ``jax.sharding.Mesh``:

* ``dp`` — frame/view parallelism: independent cameras (a render-farm /
  batched-offline axis), pure data parallel;
* ``sp`` — screen parallelism: the bin rows of the raster resolve and
  the row axis of every screen-space pass are sharded; XLA inserts the
  halo/all-gather collectives where passes read neighbours.

The cards of one host are joined all to all, so the mesh shape follows
the algorithm alone (``make_mesh(4, dp=2)`` is 2 cameras x 2 row
bands).

Geometry, materials and the texture atlas are replicated (they are the
"weights"); per-frame globals are replicated; image intermediates are
sharded on rows.
"""
from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..graph import frame as frame_mod


def make_mesh(n_devices: int | None = None, dp: int | None = None):
    """Build a (dp, sp) mesh over the first n_devices devices (dp
    defaults to 2 when n is even)."""
    devs = jax.devices()
    n = n_devices or len(devs)
    devs = devs[:n]
    if dp is None:
        dp = 2 if n % 2 == 0 and n > 1 else 1
    sp = n // dp
    arr = np.array(devs).reshape(dp, sp)
    return Mesh(arr, axis_names=("dp", "sp"))


def make_batched_render_fn(plan: frame_mod.FramePlan, mesh: Mesh,
                           row_axis: str = "sp"):
    """Batched multi-camera render step, sharded (dp over cameras, sp
    over image rows): every pass executes under SPMD partitioning.

    The row split is enforced on the INTERMEDIATES, not just the output:
    the plan carries (mesh, row_axis) and shade_stage pins every render
    target (G-buffer, hdr, resolved, color) to
    ``P(..., row_axis, None)``, so the screen-space stack partitions
    over devices rather than replicating and slicing at the end.
    """
    import dataclasses
    plan = dataclasses.replace(plan, shard_mesh=mesh, shard_axis=row_axis)

    def step(batch, globals_batch, history_batch, model_mats, normal_mats):
        def one(g, hist):
            out, h2 = frame_mod.render_frame(plan, batch, g, hist,
                                             model_mats, normal_mats)
            return out.color, h2

        colors, new_hist = jax.vmap(one)(globals_batch, history_batch)
        colors = jax.lax.with_sharding_constraint(
            colors, NamedSharding(mesh, P("dp", None, row_axis, None)))
        return colors, new_hist

    jitted = jax.jit(step)
    if not plan.shadow_statically_empty:
        return jitted

    def checked(batch, globals_batch, history_batch, model_mats,
                normal_mats):
        # same host-side guard make_render_fn applies: inside jit the
        # sun is a Tracer and check_sun_proof cannot compare it, so the
        # elision proof must be validated here, per batched camera
        # (projection_view is (B, 4, 4); np.allclose broadcasts vs the
        # proved (4, 4))
        frame_mod.check_sun_proof(plan, globals_batch)
        return jitted(batch, globals_batch, history_batch, model_mats,
                      normal_mats)

    return checked


def make_sharded_shade_fn(plan: frame_mod.FramePlan, mesh: Mesh,
                          row_axis: str = "sp"):
    """Single-camera shade_stage jit, row-sharded over `row_axis`.
    The shade stage is plain XLA (no Pallas), so this compiles natively
    on any backend — the dryrun uses it to prove the sharded
    screen-space stack executes distributed (collective-permute halo
    exchanges in the HLO).
    """
    import dataclasses
    plan = dataclasses.replace(plan, shard_mesh=mesh, shard_axis=row_axis,
                               interpret=None)

    def shade(batch, g, history, vis, records, shadow_map, overflow):
        out, h2 = frame_mod.shade_stage(plan, batch, g, history, vis,
                                        records, shadow_map, overflow)
        return out.color, h2

    return jax.jit(shade)


def shard_inputs(mesh: Mesh, batch, globals_batch, history_batch,
                 row_axis: str = "sp"):
    """Place inputs: geometry replicated, per-camera pytrees split on dp,
    history images split on (dp, rows) — matching the row layout
    shade_stage pins, so the first step pays no reshard."""
    repl = NamedSharding(mesh, P())
    dp = NamedSharding(mesh, P("dp"))
    batch = jax.device_put(batch, repl)
    globals_batch = jax.device_put(globals_batch, dp)

    def place_hist(a):
        if a.ndim >= 3:    # (B, C, H, W) image carries: rows on row_axis
            spec = P(*(["dp"] + [None] * (a.ndim - 3) + [row_axis, None]))
        else:
            spec = P("dp")
        return jax.device_put(a, NamedSharding(mesh, spec))

    history_batch = jax.tree_util.tree_map(place_hist, history_batch)
    return batch, globals_batch, history_batch


def batched_globals(gs):
    """Stack a list of ShaderGlobals into a batched pytree."""
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *gs)
