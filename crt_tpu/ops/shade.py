"""Wavefront Whitted shading.

The reference shades with a recursive CPU function over one ray
(crt_renderer.cpp:46-145).  Here the recursion is *unrolled at trace time*
over the whole ray wavefront: every level traces the full [R]-ray batch once,
material behavior is applied with masks, and the (statically bounded) set of
secondary rays — one shared reflection batch, one refraction batch, K diffuse
GI batches — recurses into the next level.  Static scene feature flags
(has_reflective / has_refractive / gi_on ...) prune branches at compile time,
so e.g. a diffuse-only scene compiles to exactly
``1 primary trace + L shadow traces`` with zero recursion.

Semantics mirrored from crt_renderer.cpp:
  - depth cutoff -> black (:47-48)
  - miss -> scene background (:143)
  - diffuse: per light  albedo * intensity / (4 pi r^2) * max(0, L.N)  with
    shadow occlusion  hit_dist^2 > r^2  (:81-96); GI hemisphere sampling with
    the PCG32 two-angle local-basis construction (:60-79)
  - reflective: albedo (*) shade(reflected) or plain albedo when reflections
    are disabled (:103-107)
  - refractive: normal flip + IOR swap on exit, Snell refraction with TIR,
    always-traced reflection, Schlick-style blend
    fresnel = 0.5 * (1 + d.n)^5 (:109-135)
  - constant: albedo sample (:137-139)

``head_compat=True`` reproduces the two quirks at the surveyed HEAD
(SURVEY.md §3.2): shadow occlusion disabled, the unconditional
``/= diffuse_reflection_ray_count + 1`` divide, and the Hadamard-product typo
(albedo.y^2, crt_vector.h:77) in reflective shading.

Gradient contract (BASELINE.json): hit triangle *indices* and visibility
masks are discrete (stop-gradient); every continuous quantity — hit distance,
point, normal, barycentrics, uv, all shading math — is recomputed from scene
arrays and differentiable w.r.t. vertices, normals, uvs, materials, textures,
lights and camera.
"""

from __future__ import annotations

import functools
import math
import os
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax.ad_checkpoint import checkpoint_name

from crt_tpu.ops import rng as rng_mod
from crt_tpu.ops import vecmath
from crt_tpu.ops.intersect import Hit
from crt_tpu.ops.texture import sample_textures
from crt_tpu.scene.types import (
    MATERIAL_CONSTANT,
    MATERIAL_DIFFUSE,
    MATERIAL_REFLECTIVE,
    MATERIAL_REFRACTIVE,
)

_PI = math.pi

# Lane compaction by occupancy for the transmissive shadow march: an
# opt-in A/B flag, off by default (compacted tiles' cluster counts inflate
# to cancel the tile reduction; not yet measured on the GPU).  The default
# is the MARCH SPLIT below (_MARCH_SPLIT).  Bit-exact either way
# (tests/test_lane_compact.py).
_SHADOW_COMPACT = os.environ.get("CRT_SHADOW_COMPACT", "0") != "0"
# Transmissive-march split: partition shadow lanes by "does refractive
# geometry touch this ray" — glass-free lanes take the w-kernel occlusion
# fast path and only glass-suspect lanes pay the faithful bend-walk.  See
# the inline note in _occlusion_masks.  Both gates are REFERENCE-EXACT
# (the walk bends at refractive hits even beyond the light,
# crt_renderer.cpp:29-44 — a round-5 capped variant that ignored
# beyond-the-light glass flipped 5.2 % of scene8's pixels and was
# retired).  _MARCH_GATE: "merged" (DEFAULT — the opaque w-pass walks
# the union of the capped shaft hull and the uncapped glass reach and
# emits the glass flag for free) or "uncapped" (a separate unbounded
# glass-member gate pass; the independently-verifiable reference
# implementation, one extra pass per bounce).
_MARCH_SPLIT = os.environ.get("CRT_MARCH_SPLIT", "1") != "0"
_MARCH_GATE = os.environ.get("CRT_MARCH_GATE", "merged")


def lane_partition(alive: jnp.ndarray):
    """Stable partition of lane indices: active lanes first.

    Returns ``(pos, perm)`` with ``pos[i]`` = compact position of original
    lane ``i`` and ``perm[j]`` = original lane at compact position ``j``
    (mutually inverse permutations).  Equivalent to the stable argsort of
    ``~alive`` but O(n): two cumsums and one unique-index scatter instead
    of a bitonic sort over the wavefront.
    """
    ai = alive.astype(jnp.int32)
    rank_act = jnp.cumsum(ai) - 1
    rank_dead = jnp.cumsum(1 - ai) - 1
    n_act = rank_act[-1] + 1
    pos = jnp.where(alive, rank_act, n_act + rank_dead)
    perm = jnp.zeros(pos.shape, jnp.int32).at[pos].set(
        jnp.arange(pos.shape[0], dtype=jnp.int32)
    )
    return pos, perm

# 07-01-scene era light direction (unit), reconstructed from the committed
# golden renders — see the legacy branch in _shade_level and
# tools/era07_fit.py for the derivation + exactness proof.  A plain tuple:
# a module-level jnp.array would initialize the XLA backend at import and
# break jax.distributed.initialize in multihost workers.
ERA07_LIGHT_DIR = (0.3809265, 0.7244545, 0.5750355)


class HitAttributes(NamedTuple):
    """Differentiable per-ray hit attributes recomputed from triangle ids.

    Mirrors crt::Intersection (crt_intersection.h:13-20) plus gathered
    material data.  Lanes where ``valid`` is False hold safe dummy values.
    """

    valid: jnp.ndarray  # [R] bool
    t: jnp.ndarray  # [R] f32 hit distance (differentiable recomputation)
    point: jnp.ndarray  # [R, 3]
    normal: jnp.ndarray  # [R, 3] shading normal (smooth or face)
    uv: jnp.ndarray  # [R, 3]
    bary_u: jnp.ndarray  # [R]
    bary_v: jnp.ndarray  # [R]
    mat_type: jnp.ndarray  # [R] i32
    albedo_tex: jnp.ndarray  # [R] i32
    ior: jnp.ndarray  # [R] f32


from crt_tpu.scene.types import TEXTURE_BITMAP, TEXTURE_CHECKER, TEXTURE_EDGES


def _needs_uv(scene) -> bool:
    """uv interpolation feeds only checker and bitmap sampling
    (crt_texture.cpp:24-45)."""
    return (
        TEXTURE_CHECKER in scene.texture_types_present
        or TEXTURE_BITMAP in scene.texture_types_present
    )


def _needs_bary(scene) -> bool:
    """barycentrics feed smooth normals, uv interpolation and the edges
    texture (crt_intersection.cpp:73-79, crt_texture.cpp:14-22)."""
    return (
        scene.any_smooth
        or _needs_uv(scene)
        or TEXTURE_EDGES in scene.texture_types_present
    )


def build_packed(scene, force_all: bool = False) -> jnp.ndarray:
    """The per-triangle shading-constant table, transposed [K, T].

    Layout: v0|v1|v2 (+n0|n1|n2 if smooth needed) (+uv0|uv1|uv2 if uv
    needed) | mat_type|mat_albedo_tex|mat_smooth|mat_ior — columns the
    scene statically cannot need are never packed; the four material rows
    are ALWAYS the last four.  Transposed so the per-hit gather output is
    [K, R]: XLA pads the minor dim to 128 lanes, so gathering [R, K] rows
    would pad K=13..31 up to 128 (a 4-10x HBM blowup, fatal for deep
    unrolled recursion); [K, R] pads only K sublanes (<= 1.4x).

    The material rows replace six standalone [T]->[R] dynamic gathers per
    hit_attributes call (tri_material -> type/tex/smooth/ior chains) with
    four extra rows of this one gather.  The discrete rows are
    stop-gradiented; the ior row stays differentiable, so d/d mat_ior flows
    through the gather VJP exactly as it used to through
    scene.mat_ior[mat].  Small ints are exact in f32.
    """
    idx = scene.tri_vidx  # [T, 3]
    cols = [
        scene.vertices[idx[:, 0]],
        scene.vertices[idx[:, 1]],
        scene.vertices[idx[:, 2]],
    ]
    if scene.any_smooth or force_all:
        cols += [
            scene.vertex_normals[idx[:, 0]],
            scene.vertex_normals[idx[:, 1]],
            scene.vertex_normals[idx[:, 2]],
        ]
    if _needs_uv(scene) or force_all:
        cols += [
            scene.vertex_uvs[idx[:, 0]],
            scene.vertex_uvs[idx[:, 1]],
            scene.vertex_uvs[idx[:, 2]],
        ]
    if scene.has_materials:
        mt = scene.tri_material  # [T]
        sg = jax.lax.stop_gradient
        cols += [
            sg(scene.mat_type[mt].astype(jnp.float32))[:, None],
            sg(scene.mat_albedo_tex[mt].astype(jnp.float32))[:, None],
            sg(scene.mat_smooth[mt].astype(jnp.float32))[:, None],
            scene.mat_ior[mt][:, None],
        ]
    else:
        cols += [jnp.zeros((idx.shape[0], 4), jnp.float32)]
    return jnp.concatenate(cols, axis=-1).T  # [K, T]


def hit_attributes(scene, origins, dirs, hit: Hit,
                   force_all: bool = False, rows_fn=None) -> HitAttributes:
    """Recompute intersection attributes exactly as crt_intersection.cpp:60-88.

    ``hit.tri`` is treated as a constant (discrete choice); everything else
    differentiates through the scene arrays.

    HBM note: all per-triangle data is gathered through ONE packed [K, T]
    table (one contiguous row per hit, see build_packed) rather than 9+
    scattered vertex gathers — random-access bytes are the cost, not
    FLOPs.  ``rows_fn(tri) -> [K, R]`` overrides the gather for partitioned
    scenes (each device holds a T/N table shard; the rows come back via a
    psum exchange — crt_tpu.parallel.scene_sharded).
    """
    tri = jnp.maximum(jax.lax.stop_gradient(hit.tri), 0)
    valid = jax.lax.stop_gradient(hit.tri) >= 0

    need_uv = _needs_uv(scene) or force_all
    need_bary = _needs_bary(scene) or force_all
    any_smooth = scene.any_smooth or force_all

    if rows_fn is None:
        from crt_tpu.ops.gather import packed_gather

        rows = packed_gather(build_packed(scene, force_all), tri)  # [K, R]
    else:
        rows = rows_fn(tri)
    # Remat seam: under jax.checkpoint(..., policy=save_only_these_names
    # ("packed_rows")) the gather output is the ONLY stored residual and the
    # elementwise interpolation below recomputes in the backward pass —
    # fusing its VJP chain instead of round-tripping every intermediate
    # [R, 3] through HBM.  A no-op without an enclosing checkpoint.
    rows = checkpoint_name(rows, "packed_rows")

    def col3(o):
        return jnp.moveaxis(rows[o : o + 3], 0, -1)  # [R, 3]

    v0, v1, v2 = col3(0), col3(3), col3(6)
    off = 9

    face_n = vecmath.safe_normalize(vecmath.cross(v1 - v0, v2 - v0))

    nd = vecmath.dot(face_n, dirs)
    opd = vecmath.dot(face_n, v0 - origins)
    t = opd / jnp.where(jnp.abs(nd) > 0, nd, 1.0)
    t = jnp.where(valid, t, 0.0)
    point = origins + dirs * t[..., None]

    if need_bary:
        # Barycentrics from cross-product magnitudes
        # (crt_intersection.cpp:71-74).  safe_length: a hit exactly on an
        # edge zeroes a numerator cross product, and d sqrt/dx at 0 would
        # NaN-poison the whole backward pass.
        v0p = point - v0
        v0v1 = v1 - v0
        v0v2 = v2 - v0
        denom = vecmath.length(vecmath.cross(v0v1, v0v2))
        denom = jnp.where(denom > 0, denom, 1.0)
        bary_u = vecmath.safe_length(vecmath.cross(v0p, v0v2)) / denom
        bary_v = vecmath.safe_length(vecmath.cross(v0v1, v0p)) / denom
    else:
        bary_u = jnp.zeros(t.shape, jnp.float32)
        bary_v = jnp.zeros(t.shape, jnp.float32)

    normal = face_n
    if any_smooth:
        n0, n1, n2 = col3(off), col3(off + 3), col3(off + 6)
        off += 9
        # NOTE: the reference does NOT renormalize the interpolated normal
        # (crt_intersection.cpp:76) — preserved here.
        smooth_n = (
            n1 * bary_u[..., None]
            + n2 * bary_v[..., None]
            + n0 * (1.0 - bary_u - bary_v)[..., None]
        )
        smooth_flag = rows[-2] > 0.5  # mat_smooth row (see build_packed)
        normal = jnp.where(smooth_flag[..., None], smooth_n, face_n)

    if need_uv:
        uv0, uv1, uv2 = col3(off), col3(off + 3), col3(off + 6)
        uv = (
            uv1 * bary_u[..., None]
            + uv2 * bary_v[..., None]
            + uv0 * (1.0 - bary_u - bary_v)[..., None]
        )
    else:
        uv = jnp.zeros(t.shape + (3,), jnp.float32)

    # Material constants decoded from the packed rows (always the last
    # four — build_packed): no standalone [T]->[R] gathers on the hot path.
    sg = jax.lax.stop_gradient
    return HitAttributes(
        valid=valid,
        t=t,
        point=point,
        normal=normal,
        uv=uv,
        bary_u=bary_u,
        bary_v=bary_v,
        mat_type=sg(rows[-4]).astype(jnp.int32),
        albedo_tex=sg(rows[-3]).astype(jnp.int32),
        ior=rows[-1],
    )


def _hadamard(albedo, color, hadamard_y: bool):
    """albedo (*) color — with the reference operator* typo when hadamard_y
    (crt_vector.h:77: y component gets an extra albedo.y factor)."""
    out = albedo * color
    if hadamard_y:
        out = out.at[..., 1].multiply(albedo[..., 1])
    return out


def _light_lum_primal(point, normal, light_positions, light_intensity, ill):
    """Direct-lighting radiance weights ``lum`` [*R]: per crt_renderer.cpp:81-96,
    sum_l ill_l * intensity_l / (4 pi r_l^2) * max(0, dir_l . normal).

    Bit-identical to the inline chain it replaces (same ops, same order:
    light_vec -> r2 -> safe_normalize -> cos_law -> masked light sum).
    """
    Ll = light_positions.shape[0]
    lead = (Ll,) + (1,) * (point.ndim - 1)
    light_vec = light_positions.reshape(lead + (3,)) - point[None]
    r2 = vecmath.length_squared(light_vec)  # [Ll, *R]
    light_dir = vecmath.safe_normalize(light_vec)
    cos_law = jnp.maximum(0.0, vecmath.dot(light_dir, normal[None]))
    sphere_area = 4.0 * _PI * r2
    return jnp.sum(
        jnp.where(
            ill, light_intensity.reshape(lead) / sphere_area * cos_law, 0.0
        ),
        axis=0,
    )


@jax.custom_vjp
def _light_lum(point, normal, light_positions, light_intensity, ill):
    return _light_lum_primal(point, normal, light_positions, light_intensity,
                             ill)


def _ll_fwd(point, normal, light_positions, light_intensity, ill):
    out = _light_lum_primal(point, normal, light_positions, light_intensity,
                            ill)
    # Residuals are the [*R, 3] inputs only — the autodiff residuals this
    # replaces include the [Ll, *R, 3] normalized direction plus several
    # [Ll, *R] scalars (~5x the HBM traffic at Ll=4).
    return out, (point, normal, light_positions, light_intensity, ill)


def _ll_bwd(res, g):
    point, normal, light_positions, light_intensity, ill = res
    eps = 1e-20  # safe_normalize's guard
    d_point = jnp.zeros_like(point)
    d_normal = jnp.zeros_like(normal)
    d_lp = []
    d_li = []
    # Static python loop over lights: each iteration's temporaries are
    # [*R](,3) fused elementwise chains — nothing [Ll, *R, 3] materializes.
    for l in range(light_positions.shape[0]):
        v = light_positions[l] - point  # [*R, 3]
        r2 = vecmath.length_squared(v)
        r2s = jnp.maximum(r2, eps)
        inv = jnp.where(r2 > eps, 1.0 / jnp.sqrt(r2s), 0.0)
        c_raw = vecmath.dot(v, normal) * inv  # == dot(dir, normal)
        # Lanes with cos<=0, unlit, or degenerate r2 contribute zero to lum
        # AND to every gradient (max(0,.) clamps; safe_normalize zeroes).
        pos = ill[l] & (c_raw > 0.0) & (r2 > eps)
        w = jnp.where(pos, light_intensity[l] / (4.0 * _PI * r2s), 0.0)
        gw = g * w  # [*R], zero off-mask
        # lum_l = k (v.n) r2^{-3/2}:  d/dn = k r2^{-3/2} v = gw inv v;
        # d/dv = gw inv n - 3 gw c_raw / r2 v;  d/dpoint = -d/dv.
        d_normal = d_normal + (gw * inv)[..., None] * v
        dv = (gw * inv)[..., None] * normal \
            - (3.0 * gw * c_raw / r2s)[..., None] * v
        d_point = d_point - dv
        d_lp.append(jnp.sum(dv.reshape(-1, 3), axis=0))
        d_li.append(jnp.sum(
            jnp.where(pos, g * c_raw / (4.0 * _PI * r2s), 0.0)
        ))
    return (d_point, d_normal, jnp.stack(d_lp),
            jnp.stack(d_li).astype(light_intensity.dtype), None)


_light_lum.defvjp(_ll_fwd, _ll_bwd)


def light_lum(point, normal, light_positions, light_intensity, illuminated):
    """Fused-VJP direct-lighting radiance sum (see RenderSettings.fused_light_vjp).

    shard_map-safe: the replicated light tables are cast to vary over the
    ray mesh axes so the per-device partial gradients type-check; the
    cast's transpose is the cross-device psum (gather._match_varying).
    """
    from crt_tpu.ops.gather import _match_varying, _vma_of

    tv = _vma_of(point)
    return _light_lum(
        point,
        normal,
        _match_varying(light_positions, tv),
        _match_varying(light_intensity, tv),
        illuminated,
    )


def _occlusion_masks(scene, trace_fn, point, normal, light_positions,
                     shadow_bias, no_shadows, shadow_active,
                     max_ray_depth=3, refraction_bias=1e-2, rows_fn=None):
    """is_illuminated per (light, ray) — all lights in ONE batched trace.

    Mirrors crt_renderer.cpp:81-96 semantics: closest hit along the shadow
    ray with hit_dist^2 > light_dist^2 meaning unoccluded.  Under
    compat_no_shadows every surface is lit (the HEAD helper never traces,
    crt_renderer.cpp:32-33).  Discrete visibility — stop-gradient by
    construction (the mask is boolean).

    The reference traces one shadow ray per light sequentially; here the
    Ll lights' wavefronts are stacked into a single [Ll*R] trace so the
    intersection backend launches once (per-light batches stay
    tile-contiguous because R is a tile multiple).

    Returns (illuminated [Ll, R] bool, light_dir [Ll, R, 3], r2 [Ll, R]).
    """
    Ll = light_positions.shape[0]
    R_px = point.shape[0] if point.ndim == 2 else None
    if R_px is not None:
        # Build FLAT-major [Ll*R, 3] first and view as [Ll, R, 3] (a free
        # contiguous reshape): producing [Ll, R, 3] first can make XLA pick
        # a tiled layout whose later flatten for the trace costs a retile.
        lv_flat = (
            jnp.repeat(light_positions, R_px, axis=0)
            - jnp.tile(point, (Ll, 1))
        )  # [Ll*R, 3]
        light_vec = lv_flat.reshape(Ll, R_px, 3)
    else:
        light_vec = light_positions[:, None, :] - point[None]  # [Ll, R, 3]
    r2 = vecmath.length_squared(light_vec)
    light_dir = vecmath.safe_normalize(light_vec)
    if no_shadows:
        return jnp.ones(r2.shape, bool), light_dir, r2

    shadow_o_px = point + normal * shadow_bias  # [R, 3], light-invariant
    # Lanes facing away from the light contribute zero regardless of
    # occlusion (cos_law clamps to 0) — drop them from the binning mask.
    facing = vecmath.dot(light_dir, jnp.broadcast_to(normal[None], light_vec.shape)) > 0.0
    act_lr = shadow_active[None] & jax.lax.stop_gradient(facing)  # [Ll, R]

    apex_w_fn = getattr(trace_fn, "shadow_apex_w", None)
    if (apex_w_fn is not None and point.ndim == 2
            and not (scene.has_refractive and scene.refractions_on)):
        # In-kernel shadow directions: the kernel derives each lane's
        # unnormalized w = light - point from the hit points and tests
        # the reference's occlusion condition as s <= 1 (exactly
        # equivalent, |w| cancels) — the [Ll*R, 3] normalized-direction
        # build + retile below never feeds a trace.
        occluded = apex_w_fn(
            jax.lax.stop_gradient(point),
            jax.lax.stop_gradient(shadow_o_px),
            light_positions,
            act_lr,
            2.0 * shadow_bias,
        )
        if occluded is not None:
            occluded = checkpoint_name(occluded.reshape(-1), "trace_out")
            return ~occluded.reshape(r2.shape), light_dir, r2

    shadow_o = jnp.broadcast_to(shadow_o_px, light_vec.shape).reshape(-1, 3)
    act = act_lr.reshape(-1)
    d = light_dir.reshape(-1, 3)
    r2_flat = jax.lax.stop_gradient(r2).reshape(-1)

    # Transmissive-march SPLIT (the 11-01 shadow-volume fix): the march's
    # L*B*R closest-hit walks dominate a refractive frame, yet for the
    # vast majority of lanes the shadow ray never meets glass and
    # the walk degenerates to one closest-hit + t^2<=r2 compare == plain
    # opaque occlusion.  So: one cheap UNCAPPED any-hit against the
    # refractive members only (refr_ray_hit_w — uncapped because the
    # reference's walk bends at glass even beyond the light) partitions
    # the wavefront; glass-free lanes resolve through the w-kernel
    # occlusion fast path and ONLY glass-suspect lanes pay the faithful
    # bend-walk below.  Exact up to the w-kernel's documented
    # boundary-measure epsilon reading (|n·w| vs |n·d|, pallas_trace
    # kernel docstring); lanes with |w| < 1 — where that reading is
    # WEAKER, not stricter — are routed to the march unconditionally.
    occ_opaque = None
    opaque_act = None
    if _MARCH_SPLIT and point.ndim == 2:
        sg = jax.lax.stop_gradient
        if _MARCH_GATE != "uncapped":
            # One-pass MERGED router (the default): the w-kernel opaque
            # pass walks the capped-hull ∪ uncapped-glass-reach union and
            # also reports "some refractive member hits anywhere on the
            # ray" — no separate gate trace, reference-exact routing.
            glass_fn = getattr(trace_fn, "shadow_apex_w_glass", None)
            if glass_fn is not None:
                res = glass_fn(
                    sg(point), sg(shadow_o_px), light_positions, act_lr,
                    2.0 * shadow_bias,
                )
                if res is not None:
                    occ_opaque, glass = res
                    march_lr = act_lr & (
                        glass | (jax.lax.stop_gradient(r2) <= 1.0)
                    )
                    opaque_act = act_lr & ~march_lr
                    act = march_lr.reshape(-1)
        else:
            # CRT_MARCH_GATE=uncapped: the same routing via a SEPARATE
            # unbounded glass-member gate pass + the plain w-kernel pass —
            # one extra shadow pass per bounce; kept as the independently
            # verifiable implementation the merged router is tested
            # against.
            gate_fn = getattr(trace_fn, "refr_ray_hit_w", None)
            apexw_fn = getattr(trace_fn, "shadow_apex_w", None)
            if gate_fn is not None and apexw_fn is not None:
                glass = gate_fn(
                    sg(point), sg(shadow_o_px), light_positions, act_lr,
                    2.0 * shadow_bias,
                )
                if glass is not None:
                    march_lr = act_lr & (
                        glass | (jax.lax.stop_gradient(r2) <= 1.0)
                    )
                    opaque_act = act_lr & ~march_lr
                    occ_opaque = apexw_fn(
                        sg(point), sg(shadow_o_px), light_positions,
                        opaque_act, 2.0 * shadow_bias,
                    )
                    if occ_opaque is not None:
                        act = march_lr.reshape(-1)
                    else:
                        opaque_act = None

    if not (scene.has_refractive and scene.refractions_on):
        sh = trace_fn(shadow_o, d, act)
        sh_t = jax.lax.stop_gradient(sh.t)
        occluded = sh.valid & (sh_t * sh_t <= r2_flat)
        occluded = checkpoint_name(occluded, "trace_out")
        return ~occluded.reshape(r2.shape), light_dir, r2

    # Transmissive shadows: the reference *intends* shadow rays to refract
    # through refractive volumes and continue (trace_ray_with_refractions,
    # crt_renderer.cpp:29-44 — dead at HEAD via the has_refracted=false init,
    # but live at the 11-01 course tags whose goldens show light through
    # glass).  Faithful wavefront version: re-trace after Snell-bending at
    # each refractive hit, up to max_ray_depth bends; TIR or a
    # non-refractive hit terminates; the LAST hit's distance (along the last
    # bent segment) is compared against the original light distance, as the
    # reference does.
    #
    # The marching step needs only the hit triangle's face normal +
    # material class + ior.  Instead of per-vertex/per-material dynamic
    # gathers (7 small-table [T]->[lanes] gathers), all marching constants
    # ride ONE [5, T] f32 column gather (face_n | is_refr | ior), and
    # iterations past the first run under a lax.cond so chunks/bounces whose
    # shadow rays never enter glass skip the trace entirely.
    if rows_fn is None:
        verts = jax.lax.stop_gradient(scene.vertices)
        tv = scene.tri_vidx
        v0t, v1t, v2t = verts[tv[:, 0]], verts[tv[:, 1]], verts[tv[:, 2]]
        face_nt = vecmath.safe_normalize(vecmath.cross(v1t - v0t, v2t - v0t))
        mat_t = scene.tri_material  # [T]
        march_tab = jax.lax.stop_gradient(
            jnp.concatenate(
                [
                    face_nt.T,  # rows 0-2
                    (scene.mat_type[mat_t] == MATERIAL_REFRACTIVE)
                    .astype(jnp.float32)[None],  # row 3
                    scene.mat_ior[mat_t][None],  # row 4
                ],
                axis=0,
            )
        )  # [5, T]

    def march_step(carry):
        o, d, alive, last_valid, last_t = carry
        sh = trace_fn(o, d, alive)
        sh_t = jax.lax.stop_gradient(sh.t)
        tri = jnp.maximum(jax.lax.stop_gradient(sh.tri), 0)
        hit_valid = sh.valid & alive

        last_valid = jnp.where(alive, sh.valid, last_valid)
        last_t = jnp.where(alive, jnp.where(sh.valid, sh_t, 0.0), last_t)

        if rows_fn is None:
            mrows = march_tab[:, tri]  # [5, Ll*R] — one fused gather
            face_n = jnp.moveaxis(mrows[0:3], 0, -1)
            is_refr = hit_valid & (mrows[3] > 0.5)
            ior = mrows[4]
        else:
            # Partitioned scenes have no raw vertices on-device; the packed
            # table's v0|v1|v2 rows (build_packed layout, always the first
            # 9) come back through the rows_fn psum exchange instead.
            rows = jax.lax.stop_gradient(rows_fn(tri))  # [K, Ll*R]
            v0 = jnp.moveaxis(rows[0:3], 0, -1)
            v1 = jnp.moveaxis(rows[3:6], 0, -1)
            v2 = jnp.moveaxis(rows[6:9], 0, -1)
            face_n = vecmath.safe_normalize(vecmath.cross(v1 - v0, v2 - v0))
            mat = scene.tri_material[tri]
            is_refr = hit_valid & (scene.mat_type[mat] == MATERIAL_REFRACTIVE)
            ior = scene.mat_ior[mat]

        d_dot_n = vecmath.dot(d, face_n)
        exiting = d_dot_n > 0.0
        n_eff = jnp.where(exiting[..., None], -face_n, face_n)
        outside_ior = jnp.where(exiting, ior, 1.0)
        inside_ior = jnp.where(exiting, 1.0, ior)
        new_d, ok = vecmath.refract(d, n_eff, outside_ior, inside_ior)

        hit_point = o + d * sh_t[..., None]
        cont = is_refr & ok  # TIR stops (occluded by the glass surface)
        o = jnp.where(cont[..., None], hit_point - n_eff * refraction_bias, o)
        d = jnp.where(cont[..., None], new_d, d)
        return o, d, cont, last_valid, last_t

    def compacted_march_step(carry):
        # Lane-compact by occupancy (see _SHADOW_COMPACT): permute the
        # active lanes to the front, march there, un-permute.  Recomputed
        # per step so the glass-marching SURVIVORS (far sparser than the
        # first segment's diffuse lanes) shrink every re-trace too.  All
        # consumed outputs are masked by ``alive`` inside march_step, so
        # results are bit-identical under any permutation.
        pos, perm = lane_partition(carry[2])
        carry_c = tuple(x[perm] for x in carry)
        carry_c = march_step(carry_c)
        return tuple(x[pos] for x in carry_c)

    step_fn = compacted_march_step if _SHADOW_COMPACT else march_step

    # Experiment knob: cap the bent-continuation depth (phase attribution
    # of the first trace vs the re-traces).  Semantics-changing — never
    # set outside experiments.
    max_ray_depth = int(os.environ.get("CRT_MARCH_DEPTH", max_ray_depth))

    def run_march(o0, d0, a0):
        """The faithful bend-walk at any wavefront width -> (valid, t)."""
        carry = (
            o0, d0, a0,  # a0: rays still marching through glass
            jnp.zeros(a0.shape, bool),
            jnp.zeros(a0.shape, jnp.float32),
        )
        carry = step_fn(carry)  # first segment
        for _ in range(max_ray_depth):
            # Bent continuations only exist where glass occludes a light
            # path — often no lanes at all, so the step (trace + gather)
            # sits under a cond.  Python loop (not scan): trace_fn's
            # binning tiers may specialize per call site; depth is tiny.
            carry = jax.lax.cond(
                jnp.any(carry[2]), step_fn, lambda c: c, carry
            )
        *_, last_valid, last_t = carry
        return last_valid, last_t

    R_flat = act.shape[0]
    BLK = 1024  # narrowing block: a multiple of the pixel tile (TILE_RAYS)
    n_blk = R_flat // BLK if R_flat % BLK == 0 else 0
    cap_blk = -(-n_blk // 4)
    if os.environ.get("CRT_MARCH_NARROW", "1") == "0":  # A/B knob
        n_blk = 0
    if occ_opaque is not None and n_blk > 0 and cap_blk < n_blk:
        # TILE-NARROW MARCH: every marching survivor is a subset of the
        # initial glass-suspect set (cont ⊆ alive at every step), and the
        # glass-suspect lanes live in SPATIALLY COHERENT pixel regions —
        # so the whole walk (first trace + all cond re-traces) runs over
        # just the LIVE 1024-lane blocks, gathered contiguously into a
        # cap_blk-block buffer.  Narrowing at BLOCK granularity keeps the
        # index build a small nonzero over blocks (a per-LANE version
        # needs a nonzero + scatter over the whole wavefront), and the
        # gathers move whole contiguous blocks (and pixel-tile
        # coherence — what the binning frustums feed on — is preserved
        # exactly).  Overflow (> cap_blk live blocks) falls back to the
        # full-width walk under a cond.
        blk_live = act.reshape(n_blk, BLK).any(axis=1)
        n_live = jnp.sum(blk_live, dtype=jnp.int32)

        def narrow(_):
            idx = jnp.nonzero(blk_live, size=cap_blk, fill_value=0)[0]
            slot_ok = jnp.arange(cap_blk, dtype=jnp.int32) < n_live
            o_b = shadow_o.reshape(n_blk, BLK, 3)[idx].reshape(-1, 3)
            d_b = d.reshape(n_blk, BLK, 3)[idx].reshape(-1, 3)
            a_b = (act.reshape(n_blk, BLK)[idx]
                   & slot_ok[:, None]).reshape(-1)
            lv, lt = run_march(o_b, d_b, a_b)
            sidx = jnp.where(slot_ok, idx, n_blk)  # OOB -> dropped
            full_v = jnp.zeros((n_blk, BLK), bool).at[sidx].set(
                lv.reshape(cap_blk, BLK), mode="drop"
            ).reshape(-1)
            full_t = jnp.zeros((n_blk, BLK), jnp.float32).at[sidx].set(
                lt.reshape(cap_blk, BLK), mode="drop"
            ).reshape(-1)
            return full_v, full_t

        last_valid, last_t = jax.lax.cond(
            n_live <= cap_blk, narrow,
            lambda _: run_march(shadow_o, d, act), None,
        )
    else:
        last_valid, last_t = run_march(shadow_o, d, act)

    occluded = (last_valid & (last_t * last_t <= r2_flat)).reshape(r2.shape)
    if occ_opaque is not None:
        # merge the split: march verdicts on glass-suspect lanes, w-kernel
        # verdicts on the rest (each masked to its own partition)
        occluded = occluded | (occ_opaque.reshape(r2.shape) & opaque_act)
    occluded = checkpoint_name(occluded.reshape(-1), "trace_out")
    return ~occluded.reshape(r2.shape), light_dir, r2


def shade_wavefront(
    scene,
    settings,
    trace_fn,
    origins: jnp.ndarray,  # [R, 3]
    dirs: jnp.ndarray,  # [R, 3]
    raster_x: Optional[jnp.ndarray] = None,  # [R] for GI RNG seeding
    raster_y: Optional[jnp.ndarray] = None,
    active: Optional[jnp.ndarray] = None,  # [R] bool; False lanes skip work
    rows_fn=None,  # partitioned-scene row gather (see hit_attributes)
    gi_salt: Optional[jnp.ndarray] = None,  # progressive-pass stream salt
) -> jnp.ndarray:
    """Shade a camera-ray wavefront -> [R, 3] linear colors.

    ``trace_fn(origins, dirs) -> Hit`` is the intersection backend (brute
    force, while-loop tree, or Pallas kernel).  ``active=False`` lanes
    (chunk padding) produce arbitrary colors the caller discards; masked
    lanes are dropped from the trace binning so they cost no kernel work.
    ``gi_salt`` (traced uint32 scalar) forks the per-pixel GI streams for
    progressive multi-pass accumulation; salt 0 is bit-exact the unsalted
    render (crt_tpu.progressive).
    """
    if scene.gi_on:
        assert raster_x is not None and raster_y is not None, (
            "GI needs raster coords for per-pixel PCG32 seeding"
        )
        rng = rng_mod.make_pcg(raster_x, raster_y)
        rng = rng_mod.salt_stream(rng, gi_salt)
    else:
        rng = None

    if active is None:
        active = jnp.ones(origins.shape[:-1], bool)

    if settings.remat_shading:
        # Policy remat: keep ONLY the trace outputs and packed hit rows as
        # backward residuals (they are the expensive, non-differentiable
        # part of the forward); recompute the cheap elementwise shading
        # chain in the backward instead of round-tripping every [R, 3]
        # intermediate through HBM.  Identity for forward-only renders.
        policy = jax.checkpoint_policies.save_only_these_names(
            "packed_rows", "trace_out"
        )

        @functools.partial(jax.checkpoint, policy=policy)
        def _shade_remat(scene, origins, dirs, rng, active):
            color, _ = _shade_level(
                scene, settings, trace_fn, origins, dirs, 0, rng, active,
                rows_fn,
            )
            return color

        return _shade_remat(scene, origins, dirs, rng, active)

    color, _ = _shade_level(
        scene, settings, trace_fn, origins, dirs, 0, rng, active, rows_fn
    )
    return color


def _shade_level(scene, settings, trace_fn, origins, dirs, depth, rng, active,
                 rows_fn=None):
    """One unrolled recursion level.  Returns (color [R,3], rng)."""
    R = origins.shape[:-1]
    black = jnp.zeros(R + (3,), jnp.float32)

    if depth > settings.max_ray_depth:  # crt_renderer.cpp:47-48
        return black, rng

    hit = trace_fn(origins, dirs, active)
    # Remat seam (see hit_attributes): traces are the expensive,
    # non-differentiable part of the forward — name their outputs so a
    # save_only_these_names("packed_rows", "trace_out") checkpoint policy
    # keeps them while recomputing the cheap elementwise shading in the
    # backward pass.  No-op without an enclosing jax.checkpoint.
    hit = Hit(
        t=checkpoint_name(hit.t, "trace_out"),
        tri=checkpoint_name(hit.tri, "trace_out"),
    )
    attrs = hit_attributes(scene, origins, dirs, hit, rows_fn=rows_fn)

    if not scene.has_materials:
        # Legacy material-less scenes (07-*): the era shaded a gray
        # half-lambert on the geometric face normal with a fixed light
        # direction hardcoded in the (lost) 07-01 tag source:
        #     gray = 0.5 + 0.5 * dot(face_normal, ERA07_LIGHT_DIR)
        # Reconstructed from the committed renders: 162 flat single-triangle
        # regions across results/png/07-01-scene-scene{1,3,4}.png pin the
        # direction to +-6e-4 per component (LP over the PPM writer's
        # truncation intervals, tools/era07_fit.py) and reproduce every
        # region's 8-bit gray EXACTLY; scene0/scene2's apparent "flat 200
        # gray" is the same rule at n=(0,0,1) -> floor(255*0.78752) = 200.
        # The HEAD loader rejects these scenes outright (crt_json.cpp:590-592).
        gray = 0.5 + 0.5 * vecmath.dot(
            attrs.normal, jnp.asarray(ERA07_LIGHT_DIR, jnp.float32)
        )
        legacy = jnp.repeat(gray[..., None], 3, axis=-1)
        return jnp.where(attrs.valid[..., None], legacy, scene.background_color), rng

    albedo = sample_textures(
        scene, attrs.albedo_tex, attrs.uv, attrs.bary_u, attrs.bary_v
    )

    is_diffuse = attrs.valid & (attrs.mat_type == MATERIAL_DIFFUSE)
    is_reflective = attrs.valid & (attrs.mat_type == MATERIAL_REFLECTIVE)
    is_refractive = attrs.valid & (attrs.mat_type == MATERIAL_REFRACTIVE)
    is_constant = attrs.valid & (attrs.mat_type == MATERIAL_CONSTANT)

    normal = attrs.normal
    point = attrs.point

    # ---- refractive geometry (computed first: it feeds the shared
    # reflection batch).  crt_renderer.cpp:113-126.
    want_refract = scene.has_refractive and scene.refractions_on
    if want_refract:
        d_dot_n = vecmath.dot(dirs, normal)
        exiting = d_dot_n > 0.0
        refr_normal = jnp.where(exiting[..., None], -normal, normal)
        outside_ior = jnp.where(exiting, attrs.ior, 1.0)
        inside_ior = jnp.where(exiting, 1.0, attrs.ior)
        refr_dir, refr_ok = vecmath.refract(
            dirs, refr_normal, outside_ior, inside_ior
        )
        refr_origin = point - refr_normal * settings.refraction_bias
    else:
        refr_normal = normal
        refr_ok = jnp.zeros(R, bool)

    # ---- shared reflection batch: reflective lanes reflect about the plain
    # shading normal, refractive lanes about the (possibly flipped) one.
    want_reflect_for_reflective = scene.has_reflective and scene.reflections_on
    need_reflection = want_reflect_for_reflective or want_refract
    if need_reflection and depth < settings.max_ray_depth + 1:
        n_eff = jnp.where(is_refractive[..., None], refr_normal, normal)
        refl_dir = vecmath.reflect(dirs, n_eff)
        refl_origin = point + n_eff * settings.reflection_bias
        refl_active = active & (
            (is_reflective if want_reflect_for_reflective else jnp.zeros(R, bool))
            | (is_refractive if want_refract else jnp.zeros(R, bool))
        )
        refl_color, rng = _shade_level(
            scene, settings, trace_fn, refl_origin, refl_dir,
            depth + 1, rng, refl_active, rows_fn,
        )
    else:
        refl_color = black

    if want_refract:
        refr_color, rng = _shade_level(
            scene, settings, trace_fn, refr_origin, refr_dir,
            depth + 1, rng, active & is_refractive & refr_ok, rows_fn,
        )
    else:
        refr_color = black

    # ---- diffuse ----------------------------------------------------------
    diffuse_color = black
    if scene.gi_on:
        gi_active = active & is_diffuse
        # Local basis from (ray, normal) — crt_renderer.cpp:62-66 (the
        # reference rebuilds it per sample; it is sample-invariant).
        right = vecmath.safe_normalize(vecmath.cross(dirs, normal))
        up = normal
        forward = vecmath.cross(right, up)
        local_m = vecmath.from_axes(right, up, forward)  # [R, 3, 3]
        gi_origin = point + normal * settings.diffuse_reflection_bias

        def one_gi_sample(carry, _):
            acc, rng = carry
            u1, rng = rng_mod.uniform(rng, gi_active)
            angle_xy = _PI * u1
            gi_dir = jnp.stack(
                [jnp.cos(angle_xy), jnp.sin(angle_xy),
                 jnp.zeros_like(angle_xy)],
                axis=-1,
            )
            u2, rng = rng_mod.uniform(rng, gi_active)
            angle_xz = 2.0 * _PI * u2
            # direction *= rotation_y(angle): batched row-vector convention.
            c, s = jnp.cos(angle_xz), jnp.sin(angle_xz)
            x, z = gi_dir[..., 0], gi_dir[..., 2]
            gi_dir = jnp.stack(
                [x * c + z * s, gi_dir[..., 1], -x * s + z * c], axis=-1
            )
            gi_dir = vecmath.rotate_rows(gi_dir, local_m)

            gi_color, rng = _shade_level(
                scene, settings, trace_fn, gi_origin, gi_dir,
                depth + 1, rng, gi_active, rows_fn,
            )
            return (acc + gi_color, rng), None

        K = settings.diffuse_reflection_ray_count
        if K == 1:
            (diffuse_color, rng), _ = one_gi_sample((diffuse_color, rng), None)
        elif K > 1:
            # lax.scan shares ONE compiled child-recursion program across
            # samples: graph size drops from (K+2)^depth to 3^depth branches
            # (identical output — the RNG state is the scan carry,
            # preserving the reference's per-pixel draw order).
            (diffuse_color, rng), _ = jax.lax.scan(
                one_gi_sample, (diffuse_color, rng), None, length=K
            )

    if scene.num_lights > 0:
        illuminated, light_dir, r2 = _occlusion_masks(
            scene, trace_fn, point, normal, scene.light_position,
            settings.shadow_bias, settings.no_shadows,
            shadow_active=active & is_diffuse,
            max_ray_depth=settings.max_ray_depth,
            refraction_bias=settings.refraction_bias,
            rows_fn=rows_fn,
        )  # [Ll, R](, 3)
        # albedo is light-invariant, so sum the scalar radiance weights over
        # lights first ([Ll, R]) and multiply by albedo once — 3x less HBM
        # on the widest shading tensors (fwd AND bwd) than materializing
        # [Ll, R, 3] per-light contributions.
        if settings.fused_light_vjp:
            lum = light_lum(point, normal, scene.light_position,
                            scene.light_intensity, illuminated)  # [R]
        else:
            cos_law = jnp.maximum(0.0, vecmath.dot(light_dir, normal[None]))
            sphere_area = 4.0 * _PI * r2
            lum = jnp.sum(
                jnp.where(
                    illuminated,
                    scene.light_intensity[:, None] / sphere_area * cos_law,
                    0.0,
                ),
                axis=0,
            )  # [R]
        diffuse_color = diffuse_color + albedo * lum[..., None]

    if settings.gi_divide:
        # HEAD quirk: unconditional divide (crt_renderer.cpp:98).
        diffuse_color = diffuse_color / (settings.diffuse_reflection_ray_count + 1)
    elif scene.gi_on:
        diffuse_color = diffuse_color / (settings.diffuse_reflection_ray_count + 1)

    # ---- reflective --------------------------------------------------------
    if want_reflect_for_reflective:
        reflective_color = _hadamard(albedo, refl_color, settings.hadamard_y)
    else:
        reflective_color = albedo  # reflections_on == false (:106)

    # ---- refractive --------------------------------------------------------
    if want_refract:
        # fresnel uses the (possibly flipped) normal (crt_renderer.cpp:130).
        fresnel = 0.5 * jnp.power(
            1.0 + vecmath.dot(dirs, refr_normal), 5.0
        )
        blended = (
            refl_color * fresnel[..., None]
            + refr_color * (1.0 - fresnel[..., None])
        )
        refractive_color = jnp.where(refr_ok[..., None], blended, refl_color)
    else:
        refractive_color = black  # refractions_on == false -> black (:110-111)

    color = jnp.where(is_diffuse[..., None], diffuse_color, scene.background_color)
    if scene.has_reflective:
        color = jnp.where(is_reflective[..., None], reflective_color, color)
    if scene.has_refractive:
        color = jnp.where(is_refractive[..., None], refractive_color, color)
    if scene.has_constant:
        color = jnp.where(is_constant[..., None], albedo, color)

    return color, rng
