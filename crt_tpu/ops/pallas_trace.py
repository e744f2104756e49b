"""Pallas GPU kernels (Triton route): tile-binned cluster-walk intersection.

The reference traverses a midpoint-split KD tree per ray with a heap stack
(crt_intersection.cpp:109-136).  The reference tree duplicates straddling
triangles heavily (~10x leaf entries on the course benchmark scene), so the
fast path uses its own acceleration structure and a two-phase scheme:

  Clustering (once per scene):
    - triangles are sorted by the Morton code of their centroid and grouped
      into consecutive clusters of CLUSTER_SIZE — every triangle in EXACTLY
      ONE cluster (no duplication), cluster AABB = union of member AABBs;
    - each cluster's test constants are one contiguous cluster-major record
      ([L, FIELDS, S] f32, see cluster_records), so a cluster is one
      contiguous read from device memory (and, after the first tile that
      walks it, from L2).

  Phase A (plain XLA, fused into the surrounding jit):
    - rays are grouped into tiles of TILE_RAYS consecutive rays (the
      renderer orders rays in TILE_H x TILE_W pixel blocks, so tiles are
      spatially coherent);
    - each tile gets a conservative *frustum* (component-wise origin and
      direction intervals; for shadow wavefronts the light-side shaft);
    - every tile frustum is tested against every cluster AABB;
    - hit cluster ids are compacted to the front of a per-tile list with a
      count (cumsum + scatter).

  Phase B (these kernels, one program per BLOCK_RAYS rays):
    - a program loads its rays and its tile's count and cluster list from
      device memory (blocks run in parallel, in no order; nothing is
      carried between programs);
    - it walks the list with a dynamic trip count; each cluster's S
      triangles are tested against the block's rays as [S, BLOCK_RAYS]
      f32 tensors (the reference's plane + three-half-space test,
      crt_intersection.cpp:47-93);
    - per-cluster winners merge into a running (best_t, best_tri) held in
      registers; exact-t ties go to the smallest triangle id.

  Conservative frustums only ever ADD clusters to a tile's list, so the
  kernels are exact: every triangle a ray could hit is tested for it.

Differentiation: the kernels produce discrete hit ids + distances that are
stop-gradiented by the caller; shading recomputes attributes differentiably
(see crt_tpu.ops.shade.hit_attributes).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from crt_tpu.ops import vecmath
from crt_tpu.ops.intersect import PARALLEL_EPS, Hit

# Binning tile: the frustum granularity of phase A.  Must equal the
# renderer's pixel tile (renderer.TILE_H * TILE_W) so frusta stay tight.
TILE_RAYS = 256
# Rays per kernel program (divides TILE_RAYS): the programs of one tile
# share its cluster list.
BLOCK_RAYS = 128
CLUSTER_SIZE = 16
# Triton launch parameters of both kernels.
NUM_WARPS = 4
NUM_STAGES = 1

# Record rows (see cluster_records): face normal, n.v0, three edge normals,
# three edge offsets, not-backface-culled flag, triangle id.
_N, _NV0, _M, _C, _NOBF, _TID = 0, 3, 4, 13, 16, 17
FIELDS = 18
_BIG_ID = 2**30


def _out_vma(*xs) -> frozenset:
    """Union varying-manual-axes over launch inputs.  Inside shard_map
    (the sharded paths run these kernels per device) the out_shape aval
    must name the mesh axes the output varies over; a bare
    ShapeDtypeStruct has vma=None, which the manual-axes checker rejects.
    Empty (a no-op) outside shard_map."""
    out = frozenset()
    for x in xs:
        try:
            out |= frozenset(getattr(jax.typeof(x), "vma", None) or ())
        except TypeError:
            pass
    return out


class ClusterTables(NamedTuple):
    """Cluster-major padded triangle constants (built once per scene)."""

    n: jnp.ndarray  # [L, S, 3] face normals (0 for pad)
    nv0: jnp.ndarray  # [L, S] n . v0
    m: jnp.ndarray  # [L, S, 9] edge normals (n x e_i), flattened
    c: jnp.ndarray  # [L, S, 3] m_i . v_i  (pad rows get c=1 -> always fail)
    nobf: jnp.ndarray  # [L, S] 1.0 if NOT backface-culled
    tri_id: jnp.ndarray  # [L, S] i32 original triangle id (-1 pad)
    cl_min: jnp.ndarray  # [L, 3] cluster AABB lower
    cl_max: jnp.ndarray  # [L, 3] cluster AABB upper


def _part1by2(x: jnp.ndarray) -> jnp.ndarray:
    """Spread 10 bits of x over 30 bits (Morton interleave helper)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def morton_order(centroids: jnp.ndarray) -> jnp.ndarray:
    """Sort order of points by 30-bit Morton code over their bounding box."""
    lo = centroids.min(axis=0)
    hi = centroids.max(axis=0)
    scale = jnp.where(hi > lo, 1023.0 / (hi - lo), 0.0)
    q = jnp.clip(((centroids - lo) * scale), 0, 1023).astype(jnp.uint32)
    code = (
        _part1by2(q[:, 0])
        | (_part1by2(q[:, 1]) << 1)
        | (_part1by2(q[:, 2]) << 2)
    )
    return jnp.argsort(code).astype(jnp.int32)


def build_cluster_tables(scene) -> ClusterTables:
    """Morton-cluster the scene's triangles and precompute test constants."""
    vertices = jax.lax.stop_gradient(scene.vertices)
    tvi = scene.tri_vidx
    backface = scene.mat_backface[scene.tri_material]
    T = tvi.shape[0]
    L = -(-T // CLUSTER_SIZE)

    pts = vertices[tvi]  # [T, 3, 3]
    centroids = pts.mean(axis=1)
    order = morton_order(centroids)

    pad = L * CLUSTER_SIZE - T
    order_padded = jnp.concatenate(
        [order, jnp.full((pad,), -1, jnp.int32)]
    ) if pad else order
    cl = order_padded.reshape(L, CLUSTER_SIZE)  # [L, S] tri ids, -1 pad

    padm = cl < 0
    ids = jnp.maximum(cl, 0)

    i0, i1, i2 = tvi[ids, 0], tvi[ids, 1], tvi[ids, 2]
    v0, v1, v2 = vertices[i0], vertices[i1], vertices[i2]  # [L, S, 3]
    n = vecmath.safe_normalize(vecmath.cross(v1 - v0, v2 - v0))
    e0, e1, e2 = v1 - v0, v2 - v1, v0 - v2
    m0, m1, m2 = vecmath.cross(n, e0), vecmath.cross(n, e1), vecmath.cross(n, e2)
    c = jnp.stack(
        [vecmath.dot(m0, v0), vecmath.dot(m1, v1), vecmath.dot(m2, v2)],
        axis=-1,
    )
    m = jnp.concatenate([m0, m1, m2], axis=-1)  # [L, S, 9]

    padf = padm[..., None].astype(jnp.float32)
    n = n * (1.0 - padf)
    c = jnp.where(padm[..., None], 1.0, c)
    nobf = jnp.where(padm, 0.0, 1.0 - backface[ids].astype(jnp.float32))

    # Cluster AABBs over member triangle points; padded members collapse to
    # the first real member so they never widen the box.
    first = jnp.broadcast_to(ids[:, :1], ids.shape)
    safe_ids = jnp.where(padm, first, ids)
    cpts = vertices[tvi[safe_ids]]  # [L, S, 3, 3]
    cl_min = cpts.min(axis=(1, 2))
    cl_max = cpts.max(axis=(1, 2))

    return ClusterTables(
        n=n,
        nv0=jnp.where(padm, 0.0, vecmath.dot(n, v0)),
        m=m * (1.0 - padf),
        c=c,
        nobf=nobf,
        tri_id=cl.astype(jnp.int32),
        cl_min=cl_min,
        cl_max=cl_max,
    )


def cluster_records(tables: ClusterTables) -> jnp.ndarray:
    """Fuse the per-slot test constants into one cluster-major record.

    Returns [L, FIELDS, S] f32: rows n(3) | n.v0 | m(9) | c(3) | nobf |
    tri_id.  Field-major within a cluster, so every field is one
    contiguous S-wide vector load and the whole cluster one contiguous
    FIELDS * S * 4-byte span.  Triangle ids ride as f32 (exact below
    2^24 = 16.7M triangles; padding slots carry -1).
    """
    L, S = tables.tri_id.shape
    if L * S >= 2**24:
        raise ValueError(f"{L * S} triangle slots exceed the f32 id range")
    rows = jnp.concatenate(
        [
            tables.n,
            tables.nv0[..., None],
            tables.m,
            tables.c,
            tables.nobf[..., None],
            tables.tri_id.astype(jnp.float32)[..., None],
        ],
        axis=-1,
    )  # [L, S, FIELDS]
    return jnp.swapaxes(rows, 1, 2)


# ---------------------------------------------------------------------------
# Phase A: tile frustums + cluster binning (plain XLA)
# ---------------------------------------------------------------------------

def _frustum_box_mask(o_lo, o_hi, d_lo, d_hi, bmin, bmax, t_cap=None,
                      t_lo_clamp: bool = True):
    """Conservative interval slab test: [tiles] frustums vs [L] boxes.

    Returns [tiles, L] bool, True if ANY ray with origin in [o_lo, o_hi] and
    direction in [d_lo, d_hi] (componentwise) could hit box [bmin, bmax] at
    t >= 0.  Per-axis interval arithmetic, each bound relaxed independently
    — a superset of the exact per-ray slab test.

    ``t_cap`` (scalar or [tiles], in the interval's OWN direction scale)
    additionally requires the earliest possible entry to lie at t <= t_cap —
    used by shadow binning to cull clusters entirely beyond the light.
    ``t_lo_clamp=False`` admits the FULL LINE below t_cap (t unbounded
    negative): the apex-side parameterization of the uncapped glass-gate
    ray, whose beyond-the-light region sits at apex-t < 0.
    """
    INF = jnp.float32(3.4e38)
    o_lo = o_lo[:, None, :]
    o_hi = o_hi[:, None, :]
    d_lo = d_lo[:, None, :]
    d_hi = d_hi[:, None, :]
    if bmin.ndim == 2:  # shared [L, 3] boxes; else already [tiles, L, 3]
        bmin = bmin[None, :, :]
        bmax = bmax[None, :, :]

    pos = d_lo > 0.0
    neg = d_hi < 0.0

    if t_lo_clamp:
        # t >= 0 regime: the classic one-corner-per-bound relaxation is
        # conservative (numerators' signs agree with the ray direction)
        ent_pos = (bmin - o_hi) / jnp.where(pos, d_hi, 1.0)
        ext_pos = (bmax - o_lo) / jnp.where(pos, d_lo, 1.0)
        ent_neg = (bmax - o_lo) / jnp.where(neg, d_lo, 1.0)
        ext_neg = (bmin - o_hi) / jnp.where(neg, d_hi, 1.0)

        t_ent = jnp.where(pos, ent_pos, jnp.where(neg, ent_neg, -INF))
        t_ext = jnp.where(pos, ext_pos, jnp.where(neg, ext_neg, INF))
        t_ent = jnp.maximum(t_ent, 0.0)
    else:
        # FULL-LINE regime (the uncapped glass gate walks apex-t < 0):
        # interval division needs all four corners — the one-corner
        # formulas silently INVERT for negative-t boxes (a per-axis
        # [entry, exit] of [-0.93, -4.44] culled a truly reachable glass
        # cluster on 11-01-scene8).
        definite = pos | neg
        safe_lo = jnp.where(definite, d_lo, 1.0)
        safe_hi = jnp.where(definite, d_hi, 1.0)
        n_lo = bmin - o_hi
        n_hi = bmax - o_lo
        c1 = n_lo / safe_lo
        c2 = n_lo / safe_hi
        c3 = n_hi / safe_lo
        c4 = n_hi / safe_hi
        tlo = jnp.minimum(jnp.minimum(c1, c2), jnp.minimum(c3, c4))
        thi = jnp.maximum(jnp.maximum(c1, c2), jnp.maximum(c3, c4))
        t_ent = jnp.where(definite, tlo, -INF)
        t_ext = jnp.where(definite, thi, INF)

    t_ent_max = jnp.max(t_ent, axis=-1)
    ok = t_ent_max <= jnp.min(t_ext, axis=-1)
    if t_cap is not None:
        cap = jnp.asarray(t_cap, jnp.float32)
        if cap.ndim == 1:
            cap = cap[:, None]
        ok = ok & (t_ent_max <= cap)
    return ok


def _apex_cone_mask(apex, w_lo, w_hi, cl_min, cl_max, slack):
    """Bounding-cone refinement of the apex shaft test -> [tiles, L] bool.

    The per-axis slab hull of a shaft overestimates DIAGONAL shafts by the
    whole axis-interval product; the shaft's bounding cone (apex P, axis
    through the direction-box center, half-angle covering the box's
    bounding ball) is rotation-tight.  Conservative both ways — shaft
    subset of cone(ball(W)) and cluster box subset of its ball, standard
    sphere-vs-cone signed-distance test — so intersecting with the slab
    mask can only drop clusters NO active segment [origin, light] can
    reach: occlusion outputs stay bit-identical
    (tests/test_shadow_binning.py).
    """
    tiny = jnp.float32(1e-12)
    c_w = 0.5 * (w_lo + w_hi)  # [tiles, 3] direction-box center
    r_w = 0.5 * jnp.sqrt(
        jnp.sum((w_hi - w_lo) ** 2, axis=-1) + tiny
    )  # [tiles]
    len_w = jnp.sqrt(jnp.sum(c_w**2, axis=-1) + tiny)
    sin_a = jnp.clip(r_w / len_w, 0.0, 1.0)
    cos_a = jnp.sqrt(jnp.maximum(1.0 - sin_a * sin_a, 0.0))
    axis = c_w / len_w[..., None]

    bc = 0.5 * (cl_min + cl_max)[None, :, :] - apex[:, None, :]  # [t, L, 3]
    r_b = (
        0.5 * jnp.sqrt(jnp.sum((cl_max - cl_min) ** 2, axis=-1))[None, :]
        + 2.0 * slack
    )
    vproj = jnp.sum(bc * axis[:, None, :], axis=-1)  # [tiles, L]
    d_ax = jnp.sqrt(
        jnp.maximum(jnp.sum(bc * bc, axis=-1) - vproj * vproj, 0.0)
    )
    e = cos_a[:, None] * d_ax - sin_a[:, None] * vproj
    ok = e <= r_b
    # degenerate shaft (apex inside the inflated origin box): sin_a
    # saturates and the axis is meaningless — pass everything
    return ok | (len_w <= r_w * 1.0001)[:, None]


def _apex_wedge_mask(apex, w_lo, w_hi, cl_min, cl_max, slack):
    """Projected 2-D wedge refinement of the apex shaft -> [tiles, L] bool.

    For each axis pair (i, j) with the direction box sign-definite in j,
    every shaft direction satisfies w_i/w_j within the box's ratio
    interval; a cluster whose (apex-relative, inflated) box has a disjoint
    ratio interval cannot be reached.  Exact in each 2-D projection —
    strictly tighter than the bounding cone for FLAT origin patches (thin
    direction boxes), conservative everywhere (interval arithmetic only
    where the denominator is sign-definite)."""
    ok = jnp.ones((apex.shape[0], cl_min.shape[0]), bool)
    b_lo = cl_min[None, :, :] - 2.0 * slack - apex[:, None, :]
    b_hi = cl_max[None, :, :] + 2.0 * slack - apex[:, None, :]
    for i, j in ((0, 1), (0, 2), (1, 2)):
        for num, den in ((i, j), (j, i)):
            d_lo, d_hi = w_lo[:, den], w_hi[:, den]  # [tiles]
            n_lo, n_hi = w_lo[:, num], w_hi[:, num]
            pos = d_lo > 0.0
            neg = d_hi < 0.0
            definite = pos | neg
            safe_lo = jnp.where(definite, d_lo, 1.0)
            safe_hi = jnp.where(definite, d_hi, 1.0)
            # ratio interval of the direction box (denominator
            # sign-definite): min/max over the 4 corner ratios
            r = jnp.stack(
                [n_lo / safe_lo, n_lo / safe_hi,
                 n_hi / safe_lo, n_hi / safe_hi], axis=-1,
            )
            w_rlo, w_rhi = r.min(-1), r.max(-1)  # [tiles]
            # cluster box ratio interval, same denominator sign demanded
            c_nlo, c_nhi = b_lo[..., num], b_hi[..., num]  # [tiles, L]
            c_dlo, c_dhi = b_lo[..., den], b_hi[..., den]
            c_def = jnp.where(pos[:, None], c_dlo > 0.0, c_dhi < 0.0)
            cs_lo = jnp.where(c_def, c_dlo, 1.0)
            cs_hi = jnp.where(c_def, c_dhi, 1.0)
            cr = jnp.stack(
                [c_nlo / cs_lo, c_nlo / cs_hi,
                 c_nhi / cs_lo, c_nhi / cs_hi], axis=-1,
            )
            c_rlo, c_rhi = cr.min(-1), cr.max(-1)  # [tiles, L]
            overlap = (c_rhi >= w_rlo[:, None]) & (c_rlo <= w_rhi[:, None])
            # a cluster straddling the denominator plane (not sign-definite
            # in den) can host directions of either sign — only cull when
            # BOTH the direction box and the cluster are definite
            ok = ok & jnp.where(
                definite[:, None] & c_def, overlap, True
            )
    return ok


def compact_mask(mask: jnp.ndarray):
    """[tiles, L] bool -> (cluster_list [tiles, L] i32, counts [tiles] i32).

    Admitted cluster ids in ascending (Morton) order at the front of each
    row; entries past ``counts`` are unspecified.  Linear work: a row
    cumsum gives each admitted cluster its slot, one scatter places it.
    """
    tiles, L = mask.shape
    pos = jnp.cumsum(mask, axis=1, dtype=jnp.int32)
    counts = pos[:, -1]
    slot = jnp.where(mask, pos - 1, L)  # unadmitted -> out of range, dropped
    rows = jnp.broadcast_to(jnp.arange(tiles, dtype=jnp.int32)[:, None],
                            mask.shape)
    ids = jnp.broadcast_to(jnp.arange(L, dtype=jnp.int32)[None, :],
                           mask.shape)
    cluster_list = jnp.zeros((tiles, L), jnp.int32).at[rows, slot].set(
        ids, mode="drop", unique_indices=True
    )
    return cluster_list, counts


@jax.named_scope("phase_a_bin")
def bin_rays(tables: ClusterTables, origins, dirs, tile_rays: int | None = None,
             active=None):
    """Phase A.  origins/dirs: [R, 3] with R % tile_rays == 0.

    ``active`` ([R] bool or None) restricts the frustum to lanes whose hit
    result is consumed downstream — crucial for shadow/secondary wavefronts
    where masked lanes carry meaningless ray data that would otherwise blow
    the tile frustum up to the whole scene.  Inactive lanes still get
    (garbage) results from whatever clusters the active lanes pull in; the
    shading masks discard them.

    Returns (cluster_list [tiles, L] i32, counts [tiles] i32).
    """
    tile_rays = tile_rays or TILE_RAYS
    tiles = origins.shape[0] // tile_rays
    o = origins.reshape(tiles, tile_rays, 3)
    d = dirs.reshape(tiles, tile_rays, 3)

    if active is None:
        o_lo, o_hi = o.min(axis=1), o.max(axis=1)
        d_lo, d_hi = d.min(axis=1), d.max(axis=1)
        tile_any = None
    else:
        INF = jnp.float32(3.4e38)
        a = active.reshape(tiles, tile_rays, 1)
        o_lo = jnp.where(a, o, INF).min(axis=1)
        o_hi = jnp.where(a, o, -INF).max(axis=1)
        d_lo = jnp.where(a, d, INF).min(axis=1)
        d_hi = jnp.where(a, d, -INF).max(axis=1)
        tile_any = jnp.any(a[..., 0], axis=1)

    mask = _frustum_box_mask(
        o_lo, o_hi, d_lo, d_hi, tables.cl_min, tables.cl_max
    )  # [tiles, L]
    if tile_any is not None:
        mask = mask & tile_any[:, None]
    return compact_mask(mask)


@jax.named_scope("phase_a_bin")
def bin_apex_shared(tables: ClusterTables, shadow_o, light_positions, active,
                    tile_rays: int | None = None, origin_slack: float = 0.0,
                    boxes=None, capped: bool = True, glass_boxes=None):
    """Apex (shaft+cone+wedge) binning of a point-light shadow wavefront
    WITHOUT materializing the per-light [Ll*R] lanes: origin boxes reduce
    ONCE over the R pixel lanes (union-of-lights active mask) and the
    per-light shafts are built directly from those [tiles_per_light, 3]
    boxes.

    Every shadow ray of a tile passes (within the bias) through its light
    point P, so the tile's reachable set is the shaft hull(origin box, P).
    Tested from the LIGHT side — origin = P exactly, direction interval =
    (origin box ± slack) − P, t ∈ [0, 1] — the interval slice at t is t·W,
    an exact scaling of the origin box, so unlike an origin-side o-box ×
    d-box product this IS the shaft (up to per-axis slab conservatism).
    Cluster boxes are inflated by 2·slack to keep bias-offset hits
    conservative.

    ``boxes`` ((cl_min, cl_max)) overrides the cluster AABBs — e.g. the
    refractive-member-only boxes of the glass-gate query (clusters with no
    member in the subset carry ±INF boxes and are never admitted).
    ``capped=False`` drops the beyond-the-light t-cap: the shaft becomes
    the unbounded cone from the light through the origin box (the glass
    gate tests the whole ray, not the segment).

    shadow_o: [R, 3] biased per-pixel origins; active: [Ll, R].
    Returns (cluster_list [Ll*tpl, L], counts [Ll*tpl]), light-major.
    """
    tile_rays = tile_rays or TILE_RAYS
    Ll = light_positions.shape[0]
    R = shadow_o.shape[0]
    tpl = R // tile_rays
    INF = jnp.float32(3.4e38)
    cl_min, cl_max = boxes if boxes is not None else (
        tables.cl_min, tables.cl_max
    )

    o = shadow_o.reshape(tpl, tile_rays, 3)
    a_any = jnp.any(active, axis=0).reshape(tpl, tile_rays, 1)
    o_lo = jnp.where(a_any, o, INF).min(axis=1)  # [tpl, 3]
    o_hi = jnp.where(a_any, o, -INF).max(axis=1)
    tile_any = jnp.any(
        active.reshape(Ll, tpl, tile_rays), axis=2
    ).reshape(-1)  # [Ll*tpl]

    s = jnp.float32(origin_slack)
    lp = light_positions[:, None, :]  # [Ll, 1, 3]
    w_lo = ((o_lo - s)[None] - lp).reshape(-1, 3)  # [Ll*tpl, 3]
    w_hi = ((o_hi + s)[None] - lp).reshape(-1, 3)
    apex = jnp.broadcast_to(lp, (Ll, tpl, 3)).reshape(-1, 3)
    # capped: the [origin, light] segment = apex-side t in [0, 1] — shaft
    # slab + cone + wedge refinements.  uncapped (glass gate): the FULL
    # shadow ray (origin -> light -> beyond) = apex-side t in (-inf, 1];
    # cone/wedge assume the t >= 0 side, so slab-only with the lower clamp
    # dropped (glass clusters are few — loose binning is fine).
    mask = _frustum_box_mask(
        apex, apex, w_lo, w_hi,
        cl_min - 2.0 * s, cl_max + 2.0 * s,
        t_cap=jnp.float32(1.0 + 1e-4),
        t_lo_clamp=capped,
    )
    if capped:
        mask = mask & _apex_cone_mask(apex, w_lo, w_hi, cl_min, cl_max, s)
        mask = mask & _apex_wedge_mask(apex, w_lo, w_hi, cl_min, cl_max, s)
    if glass_boxes is not None:
        # UNION with the uncapped glass-member reach (full-ray slab, the
        # merged one-pass router): clusters whose GLASS members a ray can
        # touch beyond the light join the walk — they cannot add s <= 1
        # occlusion hits (their capped-hull exclusion proves entry > 1),
        # only uncapped glass-flag hits.
        glo, ghi = glass_boxes
        mask = mask | _frustum_box_mask(
            apex, apex, w_lo, w_hi, glo - 2.0 * s, ghi + 2.0 * s,
            t_cap=jnp.float32(1.0 + 1e-4), t_lo_clamp=False,
        )
    mask = mask & tile_any[:, None]
    return compact_mask(mask)


# ---------------------------------------------------------------------------
# Phase B: the kernels
# ---------------------------------------------------------------------------

def _hit_test(rec_ref, cl, o, d):
    """Plane + three-half-space test of cluster ``cl``'s S triangles
    against a block of rays -> (t [S, B], valid [S, B]).

    ``o``/``d``: per-axis [1, B] ray planes.  ``d`` need not be unit: the
    occlusion kernel passes the unnormalized shadow direction w and reads
    t on the segment scale (the light at t == 1).  ``valid`` excludes
    near-parallel rays, back faces of culled materials, t < 0 and points
    outside any edge half-space (crt_intersection.cpp:47-93)."""
    def row(f):
        return rec_ref[cl, f, :][:, None]  # [S, 1]

    def dot3(f, v):
        return row(f) * v[0] + row(f + 1) * v[1] + row(f + 2) * v[2]

    nd = dot3(_N, d)
    opd = row(_NV0) - dot3(_N, o)
    not_parallel = jnp.abs(nd) >= PARALLEL_EPS
    face_ok = (opd < 0.0) | (row(_NOBF) > 0.5)
    t = opd / jnp.where(not_parallel, nd, 1.0)
    valid = not_parallel & face_ok & (t >= 0.0)
    for e in range(3):
        f = _M + 3 * e
        valid = valid & ((dot3(f, o) - row(_C + e)) + t * dot3(f, d) >= 0.0)
    return t, valid


def _rays(ref, lanes):
    return tuple(ref[k, lanes][None, :] for k in range(3))


def _closest_kernel(counts_ref, list_ref, o_ref, d_ref, rec_ref,
                    t_ref, tri_ref, *, block: int, sub: int):
    """Closest hit for one block of rays: walk the tile's cluster list,
    keep (best_t, best_tri) in registers.  Exact-t ties go to the smallest
    triangle id (the reference's first-in-scene-order rule), so the result
    does not depend on binning, walk order or how the scene is sharded."""
    p = pl.program_id(0)
    tile = p // sub
    lanes = pl.ds(p * block, block)
    o = _rays(o_ref, lanes)
    d = _rays(d_ref, lanes)

    def body(i, carry):
        best_t, best_tri = carry
        cl = list_ref[tile, i]
        t, valid = _hit_test(rec_ref, cl, o, d)
        t = jnp.where(valid, t, jnp.inf)
        cl_best = jnp.min(t, axis=0)  # [B]
        tid = rec_ref[cl, _TID, :].astype(jnp.int32)[:, None]
        cl_tri = jnp.min(
            jnp.where(t <= cl_best[None, :], tid, _BIG_ID), axis=0
        )
        better = (cl_best < best_t) | ((cl_best == best_t)
                                        & (cl_tri < best_tri))
        return (jnp.where(better, cl_best, best_t),
                jnp.where(better, cl_tri, best_tri))

    init = (jnp.full((block,), jnp.inf, jnp.float32),
            jnp.full((block,), -1, jnp.int32))
    best_t, best_tri = jax.lax.fori_loop(0, counts_ref[tile], body, init)
    t_ref[lanes] = best_t
    tri_ref[lanes] = best_tri


def _occl_kernel(counts_ref, list_ref, lp_ref, o_ref, p_ref, rec_ref, *rest,
                 block: int, sub: int, blocks_per_light: int, capped: bool,
                 member_masked: bool, glass_flag: bool):
    """Occlusion with IN-KERNEL shadow directions for one block of a
    light-major [Ll*R] shadow wavefront.

    The shadow ray from pixel point P toward light Lp is o_b + t·d̂ with
    d̂ ∝ w = Lp − P; parameterized by s along the UNNORMALIZED w the ray
    is identical and the reference's ``t² ≤ |w|²`` occlusion condition is
    exactly ``s ≤ 1`` (|w| cancels — crt_renderer.cpp:92).  So the kernel
    needs only the light position and P; no [Ll*R, 3] direction tensor is
    built.  The parallel-ray epsilon tests n·w instead of n·d̂ (stricter
    by |w|); a grazing triangle the reference drops as parallel can here
    register a blocker (tests/test_occlusion.py pins this reading).

    ``capped=False`` drops ``s ≤ 1``: any-hit along the UNBOUNDED ray — the
    transmissive-march split's glass gate (a refractive surface anywhere
    on the ray can bend it, even beyond the light: crt_renderer.cpp:29-44
    walks uncapped).  ``member_masked`` restricts hits to the slots an
    [L, S] f32 mask selects (the refractive members).  ``glass_flag``
    keeps ALL members in the occlusion output and writes a SECOND output:
    "some masked member hits anywhere on the unbounded ray" — the
    one-pass march-split router (see shade._occlusion_masks).
    """
    if member_masked or glass_flag:
        gm_ref, *rest = rest
    occ_ref = rest[0]
    q = pl.program_id(0)
    tile = q // sub
    light = q // blocks_per_light
    lanes = pl.ds((q % blocks_per_light) * block, block)
    o = _rays(o_ref, lanes)
    pt = _rays(p_ref, lanes)
    w = tuple(lp_ref[light, k] - pt[k] for k in range(3))

    def body(i, carry):
        cl = list_ref[tile, i]
        t, base = _hit_test(rec_ref, cl, o, w)
        if member_masked or glass_flag:
            glass = base & (gm_ref[cl, :][:, None] > 0.5)
        if member_masked:
            base = glass
        valid = (base & (t <= 1.0)) if capped else base
        blocked = jnp.maximum(
            carry[0], jnp.max(valid.astype(jnp.int32), axis=0)
        )
        if not glass_flag:
            return (blocked,)
        # the glass accumulator is UNCAPPED: a refractive hit anywhere on
        # the ray (even beyond the light) routes the lane to the faithful
        # bend-walk
        return (blocked, jnp.maximum(
            carry[1], jnp.max(glass.astype(jnp.int32), axis=0)
        ))

    zero = jnp.zeros((block,), jnp.int32)
    init = (zero, zero) if glass_flag else (zero,)
    out = jax.lax.fori_loop(0, counts_ref[tile], body, init)
    out_lanes = pl.ds(q * block, block)
    for ref, val in zip(rest, out):
        ref[out_lanes] = val


def _compiler_params():
    return plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=NUM_STAGES)


def _check_tiling(tile_rays: int, block: int):
    if tile_rays % block:
        raise ValueError(
            f"BLOCK_RAYS={block} must divide the binning tile {tile_rays}"
        )


def closest_hit_pallas_flat(
    tables: ClusterTables,
    origins: jnp.ndarray,  # [R, 3], R % TILE_RAYS == 0
    dirs: jnp.ndarray,
    active=None,  # [R] bool or None
    interpret: bool = False,
) -> Hit:
    """Phase A binning + the closest-hit walk over a flat wavefront."""
    _check_tiling(TILE_RAYS, BLOCK_RAYS)
    return _closest_hit_flat(tables, origins, dirs, active, interpret,
                             TILE_RAYS, BLOCK_RAYS)


@functools.partial(jax.jit,
                   static_argnames=("interpret", "tile_rays", "block"))
def _closest_hit_flat(tables, origins, dirs, active, interpret, tile_rays,
                      block):
    R = origins.shape[0]
    cluster_list, counts = bin_rays(tables, origins, dirs, tile_rays, active)
    o_t = origins.T  # [3, R]: each program reads 3 contiguous B-wide rows
    d_t = dirs.T
    rec = cluster_records(tables)
    operands = (counts, cluster_list, o_t, d_t, rec)
    vma = _out_vma(*operands)
    best_t, best_tri = pl.pallas_call(
        functools.partial(_closest_kernel, block=block,
                          sub=tile_rays // block),
        grid=(R // block,),
        out_shape=(
            jax.ShapeDtypeStruct((R,), jnp.float32, vma=vma),
            jax.ShapeDtypeStruct((R,), jnp.int32, vma=vma),
        ),
        backend="triton",
        compiler_params=_compiler_params(),
        interpret=interpret,
        name="crt_closest_hit",
    )(*operands)
    return Hit(t=best_t, tri=best_tri)


def occluded_w(rec, point, shadow_o, light_positions, cluster_list, counts,
               interpret: bool, capped: bool = True, member_mask=None,
               glass_flag: bool = False):
    """Launch the w-form occlusion kernel over a binned [Ll*R] wavefront.

    point/shadow_o: [R, 3] (shared by every light); light_positions [Ll, 3];
    cluster_list/counts from bin_apex_shared.  Returns blocked [Ll, R] bool
    (and, with ``glass_flag``, the glass-on-ray [Ll, R] bool as well).
    ``rec`` is cluster_records of the tables the lists were binned on."""
    tile_rays, block = TILE_RAYS, BLOCK_RAYS
    _check_tiling(tile_rays, block)
    R = point.shape[0]
    Ll = light_positions.shape[0]
    operands = [counts, cluster_list, light_positions, shadow_o.T, point.T,
                rec]
    if member_mask is not None:
        operands.append(member_mask)
    vma = _out_vma(*operands)
    n_out = 2 if glass_flag else 1
    outs = pl.pallas_call(
        functools.partial(
            _occl_kernel, block=block, sub=tile_rays // block,
            blocks_per_light=R // block, capped=capped,
            member_masked=member_mask is not None and not glass_flag,
            glass_flag=glass_flag,
        ),
        grid=(Ll * R // block,),
        out_shape=tuple(
            jax.ShapeDtypeStruct((Ll * R,), jnp.int32, vma=vma)
            for _ in range(n_out)
        ),
        backend="triton",
        compiler_params=_compiler_params(),
        interpret=interpret,
        name="crt_occluded_w",
    )(*operands)
    outs = tuple((x > 0).reshape(Ll, R) for x in outs)
    return outs if glass_flag else outs[0]


def make_pallas_trace_fn(scene, interpret: bool = False):
    """trace_fn factory for the Pallas backend.

    ``trace(origins, dirs, active=None) -> Hit`` is the closest-hit walk.
    Shadow queries of point-light wavefronts go through ``shadow_apex_w``
    (and, on refractive scenes, ``shadow_apex_w_glass`` / ``refr_ray_hit_w``
    for the transmissive-march router) — see shade._occlusion_masks.
    """
    tables = jax.tree.map(jax.lax.stop_gradient, build_cluster_tables(scene))
    rec = cluster_records(tables)
    sg = jax.lax.stop_gradient

    def trace(origins, dirs, active=None):
        batch_shape = origins.shape[:-1]
        o = sg(origins).reshape(-1, 3)
        d = sg(dirs).reshape(-1, 3)
        R = o.shape[0]
        pad = (-R) % TILE_RAYS
        a = None if active is None else sg(active).reshape(-1)
        if pad:
            o = jnp.concatenate([o, jnp.zeros((pad, 3), o.dtype)])
            dpad = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]], d.dtype), (pad, 1))
            d = jnp.concatenate([d, dpad])
            a = jnp.concatenate([
                jnp.ones((R,), bool) if a is None else a,
                jnp.zeros((pad,), bool),
            ])
        hit = closest_hit_pallas_flat(tables, o, d, a, interpret=interpret)
        return Hit(
            t=hit.t[:R].reshape(batch_shape),
            tri=hit.tri[:R].reshape(batch_shape),
        )

    def _shadow(point, shadow_o, light_positions, active, origin_slack,
                capped=True, member_mask=None, glass_flag=False,
                boxes=None, glass_boxes=None):
        Ll, R = active.shape
        if R % TILE_RAYS:
            return None  # caller falls back to the generic trace
        cluster_list, counts = bin_apex_shared(
            tables, sg(shadow_o), sg(light_positions), sg(active),
            TILE_RAYS, origin_slack, boxes=boxes, capped=capped,
            glass_boxes=glass_boxes,
        )
        return occluded_w(
            rec, sg(point), sg(shadow_o), sg(light_positions),
            cluster_list, counts, interpret, capped=capped,
            member_mask=member_mask, glass_flag=glass_flag,
        )

    def shadow_apex_w(point, shadow_o, light_positions, active,
                      origin_slack):
        """Occlusion masks with in-kernel shadow directions -> [Ll, R]
        bool (None when R is not a tile multiple).  ``point`` [R, 3]
        unbiased hit points, ``shadow_o`` [R, 3] biased origins, ``active``
        [Ll, R]; the occlusion condition is s ≤ 1 along w = light − point
        (see _occl_kernel)."""
        return _shadow(point, shadow_o, light_positions, active,
                       origin_slack)

    trace.shadow_apex_w = shadow_apex_w

    if not (scene.has_materials and scene.has_refractive):
        return trace

    def _glass_subset():
        """[L, S] f32 refractive-member mask + member-only cluster AABBs.

        Same tables, no rebuild: clusters keep their slots; non-glass
        members are masked in-kernel and the binning boxes shrink to the
        glass members (clusters with none carry ±INF boxes -> never
        admitted).
        """
        from crt_tpu.scene.types import MATERIAL_REFRACTIVE

        INF = jnp.float32(3.4e38)
        ids = jnp.maximum(tables.tri_id, 0)
        padm = tables.tri_id < 0
        is_glass = (
            scene.mat_type[scene.tri_material] == MATERIAL_REFRACTIVE
        )[ids] & ~padm  # [L, S]
        pts = sg(scene.vertices)[scene.tri_vidx[ids]]  # [L, S, 3, 3]
        g = is_glass[..., None, None]
        gmin = jnp.where(g, pts, INF).min(axis=(1, 2))  # [L, 3]
        gmax = jnp.where(g, pts, -INF).max(axis=(1, 2))
        return is_glass.astype(jnp.float32), gmin, gmax

    def shadow_apex_w_glass(point, shadow_o, light_positions, active,
                            origin_slack):
        """ONE w-kernel pass -> (occluded [Ll, R], glass_on_ray [Ll, R]):
        the occlusion bits of shadow_apex_w plus "some REFRACTIVE member
        hits anywhere on the UNBOUNDED ray" — the one-pass
        transmissive-march router (shade._occlusion_masks).  The binning
        walks the union of the capped shaft hull and the uncapped
        glass-member reach (the extra clusters cannot add s <= 1
        occlusion hits); the kernel's glass accumulator drops the cap."""
        gm, gmin, gmax = _glass_subset()
        return _shadow(point, shadow_o, light_positions, active,
                       origin_slack, member_mask=gm, glass_flag=True,
                       glass_boxes=(gmin, gmax))

    def refr_ray_hit_w(point, shadow_o, light_positions, active,
                       origin_slack):
        """[Ll, R] bool: can the UNCAPPED shadow ray touch refractive
        geometry?  The separate-pass form of the march router's glass gate
        (shade._MARCH_GATE == "uncapped"), kept as the independently
        verifiable reference of the merged router."""
        gm, gmin, gmax = _glass_subset()
        return _shadow(point, shadow_o, light_positions, active,
                       origin_slack, capped=False, member_mask=gm,
                       boxes=(gmin, gmax))

    trace.shadow_apex_w_glass = shadow_apex_w_glass
    trace.refr_ray_hit_w = refr_ray_hit_w
    return trace


# ---------------------------------------------------------------------------
# XLA reference evaluation of the cluster tables (kernel oracle + the local
# intersection of partitioned scenes on the CPU)
# ---------------------------------------------------------------------------

def closest_hit_tables(tables: ClusterTables, origins, dirs,
                       chunk_slots: int = 4096) -> Hit:
    """Dense closest-hit over every cluster slot, plain XLA.

    Exactly the kernel's per-triangle test (plane + three half-spaces,
    backface gate, min-t with min-triangle-id tie break) without binning —
    O(R x slots), meant for tests and as the CPU-mesh local intersection of
    the scene-partitioned path.  ``chunk_slots`` bounds the materialized
    [R, chunk] intermediates.
    """
    L, S = tables.tri_id.shape
    n = tables.n.reshape(L * S, 3)
    nv0 = tables.nv0.reshape(L * S)
    m = tables.m.reshape(L * S, 9)
    c = tables.c.reshape(L * S, 3)
    nobf = tables.nobf.reshape(L * S)
    tid = tables.tri_id.reshape(L * S)

    o = origins.reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    INF = jnp.float32(jnp.inf)
    BIGID = jnp.int32(_BIG_ID)

    pad = (-(L * S)) % chunk_slots
    if pad:
        n = jnp.concatenate([n, jnp.zeros((pad, 3), n.dtype)])
        nv0 = jnp.concatenate([nv0, jnp.zeros((pad,), nv0.dtype)])
        m = jnp.concatenate([m, jnp.zeros((pad, 9), m.dtype)])
        c = jnp.concatenate([c, jnp.ones((pad, 3), c.dtype)])
        nobf = jnp.concatenate([nobf, jnp.zeros((pad,), nobf.dtype)])
        tid = jnp.concatenate([tid, jnp.full((pad,), -1, jnp.int32)])
    chunks = (L * S + pad) // chunk_slots

    # f32 dots must not run in TF32 (about three decimal digits) on the GPU
    hi = jax.lax.Precision.HIGHEST

    def one_chunk(carry, xs):
        best_t, best_tri = carry
        cn, cnv0, cm, cc, cnobf, ctid = xs  # [chunk, ...]
        nd = jnp.einsum("sc,rc->rs", cn, d, precision=hi)  # [R, chunk]
        no = jnp.einsum("sc,rc->rs", cn, o, precision=hi)
        opd = cnv0[None, :] - no
        not_parallel = jnp.abs(nd) >= PARALLEL_EPS
        front = opd < 0.0
        face_ok = front | (cnobf[None, :] > 0.5)
        t = opd / jnp.where(not_parallel, nd, 1.0)
        valid = not_parallel & face_ok & (t >= 0.0)
        for e in range(3):
            md = jnp.einsum("sc,rc->rs", cm[:, 3 * e : 3 * e + 3], d,
                            precision=hi)
            mo = jnp.einsum("sc,rc->rs", cm[:, 3 * e : 3 * e + 3], o,
                            precision=hi)
            valid = valid & ((mo - cc[None, :, e]) + t * md >= 0.0)
        t = jnp.where(valid & (ctid[None, :] >= 0), t, INF)
        ch_best = jnp.min(t, axis=1)
        cand = jnp.where(t <= ch_best[:, None], ctid[None, :], BIGID)
        ch_tri = jnp.min(cand, axis=1)
        better = (ch_best < best_t) | ((ch_best == best_t)
                                       & (ch_tri < best_tri))
        return (
            jnp.where(better, ch_best, best_t),
            jnp.where(better, ch_tri, best_tri),
        ), None

    # init derived from the ray AND table inputs so its varying-manual-axes
    # type under shard_map matches the scan outputs (a plain jnp.full is
    # unvarying on every mesh axis and trips the carry type check)
    zero = (o[:, 0] + d[:, 0]) * 0.0 + nv0[:1].sum() * 0.0
    init = (zero + INF, zero.astype(jnp.int32) - 1)
    xs = tuple(
        x.reshape((chunks, chunk_slots) + x.shape[1:])
        for x in (n, nv0, m, c, nobf, tid)
    )
    (best_t, best_tri), _ = jax.lax.scan(one_chunk, init, xs)
    best_tri = jnp.where(jnp.isinf(best_t), -1, best_tri)
    return Hit(t=best_t, tri=best_tri)
