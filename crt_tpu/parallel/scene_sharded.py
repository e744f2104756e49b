"""Scene-partitioned rendering: each device HOLDS 1/N of the scene.

The course scenes are tiny (<= 4k triangles) so the default data-parallel
path replicates the scene and shards rays (sharded.py).  This module covers
the opposite regime — scenes too large for one chip's HBM.  The heavy
per-triangle state is physically partitioned over a mesh axis:

  - the Morton-cluster intersection tables (ClusterTables, 17 f32 per
    triangle slot — the dominant term) sharded over the cluster axis;
  - the packed shading-constant table ([K, T] f32, K = 9..27 — see
    crt_tpu.ops.shade.build_packed) sharded over the triangle axis.

Per trace, each device intersects the wavefront against its local cluster
shard (the Pallas kernel on the GPU, the XLA table oracle on the CPU) and
partial hits min-combine across the scene axis with two ``pmin``
collectives.  Shading then needs the winning triangle's constants, which
live on exactly one shard: every device gathers rows for the hits it owns
and one ``psum`` broadcast assembles the full [K, R] row block — the
ray-tracing cousin of sequence-parallel attention (reduction over context
distributes; only O(K x R) activations ever cross the interconnect, never
scene data).

A 2-D ("rays", "scene") mesh composes this with ray data-parallelism.
Replicated remainder: per-triangle material ids (4 B/tri), the per-material
/texture/light tables, and the camera — a few percent of scene bytes.

SURVEY.md §5 "long-context" requirement; no reference equivalent exists
(single process, crt_renderer.cpp:157-199).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from crt_tpu.ops import camera as camera_ops
from crt_tpu.ops.intersect import Hit
from crt_tpu.ops.pallas_trace import (
    TILE_RAYS,
    ClusterTables,
    bin_apex_shared,
    build_cluster_tables,
    closest_hit_pallas_flat,
    closest_hit_tables,
    cluster_records,
    occluded_w,
)
from crt_tpu.ops.shade import build_packed, shade_wavefront
from crt_tpu.scene.types import RenderSettings, Scene

_BIG_ID = jnp.int32(2**30)


def _combine_hits_across(axis: str, hit: Hit) -> Hit:
    """Min-combine partial closest hits over a mesh axis.

    Distance: plain pmin.  Triangle id: the reference's tie rule is
    first-in-traversal-order; across shards we pick the smallest triangle id
    among the lanes achieving the winning distance (ids are globally
    consistent because clusters hold original triangle ids).
    """
    best_t = jax.lax.pmin(hit.t, axis)
    cand = jnp.where(hit.t <= best_t, jnp.where(hit.tri < 0, _BIG_ID, hit.tri),
                     _BIG_ID)
    best_tri = jax.lax.pmin(cand, axis)
    best_tri = jnp.where(best_tri >= _BIG_ID, -1, best_tri)
    return Hit(t=best_t, tri=best_tri)


def _pad_axis(x, mult, axis, fill):
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths, constant_values=fill)


def pad_tables_for_shards(tables: ClusterTables, n: int) -> ClusterTables:
    """Pad the cluster axis to a shard multiple with never-hit clusters:
    degenerate test constants (c=1, n=0), inverted AABBs (binning skips),
    tri_id=-1."""
    INF = jnp.float32(3.4e38)
    return ClusterTables(
        n=_pad_axis(tables.n, n, 0, 0.0),
        nv0=_pad_axis(tables.nv0, n, 0, 0.0),
        m=_pad_axis(tables.m, n, 0, 0.0),
        c=_pad_axis(tables.c, n, 0, 1.0),
        nobf=_pad_axis(tables.nobf, n, 0, 0.0),
        tri_id=_pad_axis(tables.tri_id, n, 0, -1),
        cl_min=_pad_axis(tables.cl_min, n, 0, INF),
        cl_max=_pad_axis(tables.cl_max, n, 0, -INF),
    )


def build_partitioned_tables(scene: Scene, mesh: Mesh, scene_axis: str):
    """(tables, packed, shard_tris) with device placement sharded over
    ``scene_axis`` — no device ever materializes the full tables.

    ``packed`` is padded on the triangle axis to a shard multiple;
    ``shard_tris`` is the static per-shard triangle count.
    """
    n = mesh.shape[scene_axis]
    tables = pad_tables_for_shards(build_cluster_tables(scene), n)
    tables = jax.tree.map(jax.lax.stop_gradient, tables)
    packed = _pad_axis(build_packed(scene), n, 1, 0.0)
    shard_tris = packed.shape[1] // n

    table_sharding = NamedSharding(mesh, P(scene_axis))
    packed_sharding = NamedSharding(mesh, P(None, scene_axis))
    tables = jax.tree.map(
        lambda x: jax.device_put(x, table_sharding), tables
    )
    packed = jax.device_put(packed, packed_sharding)
    return tables, packed, shard_tris


def _resolve_shard_backend(backend: str) -> str:
    """Shard-local backend: "auto" is the Pallas kernel on the GPU and the
    XLA table oracle on the CPU (the Pallas interpreter cannot evaluate
    kernels whose operands vary over manual mesh axes)."""
    if backend != "auto":
        return backend
    platform = jax.default_backend()
    if platform == "gpu":
        return "pallas"
    if platform == "cpu":
        return "tables"
    raise RuntimeError(
        f"local_backend='auto' has no default on platform {platform!r}"
    )


def make_partitioned_trace_fn(local_tables: ClusterTables, scene_axis: str,
                              backend: str = "auto"):
    """trace_fn over a LOCAL cluster-table shard + pmin combine.

    Must be called inside shard_map.  ``active`` masks feed the Pallas
    binning (dead tiles cost nothing); cluster tri_ids are global, so no
    id translation is needed.  Backends: "pallas" (the cluster-walk
    kernel), "tables" (XLA oracle); "auto" per _resolve_shard_backend.
    """
    backend = _resolve_shard_backend(backend)
    if backend not in ("pallas", "tables"):
        raise ValueError(f"unknown shard-local backend: {backend!r}")

    def trace(origins, dirs, active=None):
        o = jax.lax.stop_gradient(origins.reshape(-1, 3))
        d = jax.lax.stop_gradient(dirs.reshape(-1, 3))
        R = o.shape[0]
        if backend == "pallas":
            pad = (-R) % TILE_RAYS
            a = jnp.ones((R,), bool) if active is None else \
                jax.lax.stop_gradient(active.reshape(-1))
            if pad:
                o = jnp.concatenate([o, jnp.zeros((pad, 3), o.dtype)])
                d = jnp.concatenate(
                    [d, jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]]), (pad, 1))]
                )
                a = jnp.concatenate([a, jnp.zeros((pad,), bool)])
            local = closest_hit_pallas_flat(local_tables, o, d, a)
            local = Hit(t=local.t[:R], tri=local.tri[:R])
        else:
            local = closest_hit_tables(local_tables, o, d)
        local = Hit(
            t=local.t.reshape(origins.shape[:-1]),
            tri=local.tri.reshape(origins.shape[:-1]),
        )
        return _combine_hits_across(scene_axis, local)

    if backend == "pallas":
        rec = cluster_records(local_tables)
        sg = jax.lax.stop_gradient

        def shadow_apex_w(point, shadow_o, light_positions, active,
                          origin_slack):
            """w-form occlusion (pallas_trace._occl_kernel) against the
            local shard; a lane is shadowed iff ANY shard holds a blocker,
            so the bits OR-combine (pmax) across the scene axis."""
            if active.shape[1] % TILE_RAYS:
                return None
            cluster_list, counts = bin_apex_shared(
                local_tables, sg(shadow_o), sg(light_positions), sg(active),
                TILE_RAYS, origin_slack,
            )
            occ = occluded_w(
                rec, sg(point), sg(shadow_o), sg(light_positions),
                cluster_list, counts, interpret=False,
            )
            return jax.lax.pmax(occ.astype(jnp.int32), scene_axis) > 0

        trace.shadow_apex_w = shadow_apex_w
    return trace


def make_partitioned_rows_fn(local_packed: jnp.ndarray, shard_tris: int,
                             scene_axis: str):
    """Row gather for hit_attributes over a packed-table shard.

    Each device gathers the rows of hits whose triangle it owns (masked
    local gather) and a single psum assembles the full [K, R] block on
    every device — the only cross-device motion of shading data.
    """

    def rows_fn(tri):
        k = jax.lax.axis_index(scene_axis)
        local = tri - k * shard_tris
        mine = (local >= 0) & (local < shard_tris)
        rows = local_packed[:, jnp.clip(local, 0, shard_tris - 1)]
        rows = jnp.where(mine[None, :], rows, 0.0)
        return jax.lax.psum(rows, scene_axis)

    return rows_fn


def render_image_scene_sharded(
    scene: Scene,
    settings: RenderSettings | None = None,
    mesh: Mesh | None = None,
    rays_axis: str = "rays",
    scene_axis: str = "scene",
    local_backend: str = "auto",
) -> jnp.ndarray:
    """Forward render on a 2-D ("rays", "scene") mesh with the scene's
    per-triangle state physically partitioned over ``scene_axis``.

    Pixel rows are sharded over ``rays_axis``; intersection + shading
    constants are sharded over ``scene_axis`` (see module docstring).
    Output matches the single-device render up to f32 reduction order.
    """
    settings = settings or RenderSettings()
    if mesh is None:
        devs = np.array(jax.devices())
        mesh = Mesh(devs.reshape(2, -1), (rays_axis, scene_axis))

    n_ray = mesh.shape[rays_axis]
    tables, packed, shard_tris = build_partitioned_tables(
        scene, mesh, scene_axis
    )

    h, w = scene.height, scene.width
    rows_per = -(-h // n_ray)
    h_pad = rows_per * n_ray

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(scene_axis), P(None, scene_axis), P(rays_axis)),
        out_specs=P(rays_axis, None),
    )
    def _shard(scene_rep, tables_local, packed_local, row_starts):
        from crt_tpu.ops.shade_iter import shade_wavefront_iter
        from crt_tpu.renderer import make_tiler, use_iterative_wavefront

        rx, ry, untile = make_tiler(rows_per, w, row_offset=row_starts[0])
        origins, dirs = camera_ops.generate_rays(
            scene_rep.cam_position, scene_rep.cam_rotation,
            scene_rep.cam_tan_half_fov, w, h, rx, ry,
        )
        trace_fn = make_partitioned_trace_fn(
            tables_local, scene_axis, local_backend
        )
        rows_fn = make_partitioned_rows_fn(
            packed_local, shard_tris, scene_axis
        )
        # Same shading-strategy policy as the single-device renderer:
        # branching Whitted trees (refractive depth>=2, GI) go through the
        # O(depth) bank wavefront instead of re-unrolling 2^depth traces.
        # Refractive scenes work here too: the transmissive shadow
        # marching's vertex reads route through the rows_fn psum exchange.
        if use_iterative_wavefront(scene_rep, settings):
            color = shade_wavefront_iter(
                scene_rep, settings, trace_fn,
                origins.reshape(-1, 3), dirs.reshape(-1, 3),
                rx.astype(jnp.uint32), ry.astype(jnp.uint32),
                rows_fn=rows_fn, vary_axes=(rays_axis,),
            )
        else:
            color = shade_wavefront(
                scene_rep, settings, trace_fn,
                origins.reshape(-1, 3), dirs.reshape(-1, 3),
                rx.astype(jnp.uint32), ry.astype(jnp.uint32),
                rows_fn=rows_fn,
            )
        return untile(color)

    # the heavy arrays were already consumed into tables/packed; ship a
    # slim scene so no device replicates the full geometry
    slim = scene.replace(
        vertices=jnp.zeros((0, 3), jnp.float32),
        vertex_normals=jnp.zeros((0, 3), jnp.float32),
        vertex_uvs=jnp.zeros((0, 3), jnp.float32),
        tri_vidx=jnp.zeros((0, 3), jnp.int32),
        accel=None,
    )
    row_starts = jnp.arange(0, h_pad, rows_per, dtype=jnp.int32)
    img = jax.jit(_shard)(slim, tables, packed, row_starts)
    return img[:h]


def scene_sharded_value_and_grad(
    scene: Scene,
    target: jnp.ndarray,  # [H, W, 3]
    params: dict | None = None,
    settings: RenderSettings | None = None,
    mesh: Mesh | None = None,
    rays_axis: str = "rays",
    scene_axis: str = "scene",
    local_backend: str = "auto",
):
    """L2 loss + scene-parameter gradients on the 2-D (rays x scene) mesh.

    The partitioned-scene *training step*: rows sharded over ``rays_axis``,
    per-triangle state over ``scene_axis`` (pmin hit-combine + psum row
    exchange, exactly the forward path of render_image_scene_sharded), with
    gradients flowing back THROUGH the psum row exchange into the scene
    parameters.  Differentiable-parameter plumbing:

      - trainable params (sharded.default_trainable_params by default) are
        replicated — like any data-parallel trainer replicates its weights;
      - the packed shading-constant table is rebuilt from the params inside
        the step and dynamic-sliced to the local shard, so AD's transpose
        of the slice + psum exchange routes each hit row's cotangent to the
        owning shard and on into vertices/albedo/lights/camera (the
        transient full [K, T] build is per-step scratch; the PERSISTENT
        partitioned state — cluster tables, packed shards — stays 1/N);
      - intersection runs on prebuilt stop-gradient cluster-table shards
        (hit ids are discrete per the gradient contract, BASELINE.json).

    Returns (loss, grads), both replicated; parity with the single-device
    ``jax.grad`` of the same loss is gated by tests/test_scene_sharded.py.
    """
    from crt_tpu.parallel.sharded import default_trainable_params

    settings = settings or RenderSettings()
    if mesh is None:
        devs = np.array(jax.devices())
        mesh = Mesh(devs.reshape(2, -1), (rays_axis, scene_axis))
    n_ray = mesh.shape[rays_axis]
    n_scene = mesh.shape[scene_axis]
    params = params if params is not None else default_trainable_params(scene)

    tables, _packed0, shard_tris = build_partitioned_tables(
        scene, mesh, scene_axis
    )

    h, w = scene.height, scene.width
    rows_per = -(-h // n_ray)
    h_pad = rows_per * n_ray
    if h_pad != h:
        pad = jnp.zeros((h_pad - h, w, 3), target.dtype)
        target = jnp.concatenate([target, pad], axis=0)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(scene_axis), P(rays_axis), P(rays_axis)),
        out_specs=(P(), P()),
    )
    def _step(scene_rep, p, tables_local, target_rows, row_starts):
        from crt_tpu.ops.shade_iter import shade_wavefront_iter
        from crt_tpu.renderer import make_tiler, use_iterative_wavefront

        def loss_fn(p):
            s = scene_rep.replace(**p)
            packed_full = _pad_axis(build_packed(s), n_scene, 1, 0.0)
            k = jax.lax.axis_index(scene_axis)
            packed_local = jax.lax.dynamic_slice_in_dim(
                packed_full, k * shard_tris, shard_tris, axis=1
            )
            rx, ry, untile = make_tiler(rows_per, w,
                                        row_offset=row_starts[0])
            origins, dirs = camera_ops.generate_rays(
                s.cam_position, s.cam_rotation, s.cam_tan_half_fov,
                w, h, rx, ry,
            )
            trace_fn = make_partitioned_trace_fn(
                tables_local, scene_axis, local_backend
            )
            rows_fn = make_partitioned_rows_fn(
                packed_local, shard_tris, scene_axis
            )
            if use_iterative_wavefront(s, settings):
                color = shade_wavefront_iter(
                    s, settings, trace_fn,
                    origins.reshape(-1, 3), dirs.reshape(-1, 3),
                    rx.astype(jnp.uint32), ry.astype(jnp.uint32),
                    rows_fn=rows_fn, vary_axes=(rays_axis,),
                )
            else:
                color = shade_wavefront(
                    s, settings, trace_fn,
                    origins.reshape(-1, 3), dirs.reshape(-1, 3),
                    rx.astype(jnp.uint32), ry.astype(jnp.uint32),
                    rows_fn=rows_fn,
                )
            img = untile(color)
            valid = (row_starts[0] + jnp.arange(rows_per)) < h
            err = jnp.where(valid[:, None, None], img - target_rows, 0.0)
            return jnp.sum(err * err) / (h * w * 3)

        loss, grads = jax.value_and_grad(loss_fn)(p)
        # loss varies over rays only (the psum row exchange already left
        # color scene-invariant); grads come back replicated via AD's
        # transpose of the replicated->varying casts (see sharded.py).
        loss = jax.lax.psum(loss, rays_axis)
        return loss, grads

    # the step rebuilds packed/rays from params; strip only the prebuilt
    # accel (tri_vidx and vertex tables are needed by build_packed)
    slim = scene.replace(accel=None)
    row_starts = jnp.arange(0, h_pad, rows_per, dtype=jnp.int32)
    return jax.jit(_step)(slim, params, tables, target, row_starts)
