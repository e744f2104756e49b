"""Iterative bank-structured Whitted wavefront — O(depth) trace programs.

The recursive wavefront in crt_tpu.ops.shade unrolls the reference's
shade_ray recursion (crt_renderer.cpp:46-145) at trace time: a refractive
scene compiles 2^depth trace programs and a GI scene (K+2)^depth scan
branches.  This module replaces the call *tree* with a depth-bounded
iteration over a bank-structured ray pool.  Two schedules
(``RenderSettings.wavefront_sched``):

  - "scan": ``lax.scan`` over a fixed-capacity pool — ONE compiled bounce
    body, D+1 trace launches regardless of branching (best compile time;
    the default for non-GI scenes).
  - "grow": an unrolled loop whose pool GROWS 1 -> f -> f^2 -> B banks
    across bounces (f = max per-parent fanout), with depth-D leaf children
    folded inline (no placement) and a spawn-free terminal bounce — D+1
    compiled bodies buy skipping every dead bank's trace lanes and
    bookkeeping.  Default for GI scenes, whose cost is ~linear in pool
    width; makes the EXACT f^D-wide Whitted tree affordable.

Pool layout — the wavefront trick.  The pool is B *banks* of R lanes, and
slot (b, p) permanently belongs to pixel p.  Consequences:

  - path radiance accumulates ELEMENTWISE into a [B, R, 3] buffer and the
    final image is one ``sum(axis=0)`` — no scatter-adds;
  - spawned children (the refractive Fresnel pair's second ray, the K
    diffuse-GI samples) only ever move along the tiny bank axis: free-slot
    matching is a cumsum + one-hot product over [B, B, R] — no argsort
    compaction of the full wavefront;
  - each bank preserves the renderer's pixel-tile ray order, so the Pallas
    trace binning sees the same coherent pixel tiles as the primary pass.

Path weights: a lane carries throughput = the product of per-bounce factors
(albedo for mirrors incl. the Hadamard-y compat quirk, fresnel /
1-fresnel for the refractive pair, 1/(K+1) for GI samples), so the Whitted
tree's bottom-up blend  fresnel*refl + (1-fresnel)*refr  becomes a sum over
root-to-leaf paths — identical up to f32 summation order.

Capacity: children that find no free bank in their column are DROPPED
(counted in the returned diagnostics).  Defaults: GI scenes get the EXACT
tree width f^D (zero drops — round 3 measured the old heuristic dropping
10.6 M children on the 15-01 showcase); pure reflect/refract scenes keep
2^min(D,3) (zero drops at depth <= 3; beyond that the Fresnel tree is
weight-starved and drops are sub-noise).  ``wavefront_banks`` trades
completeness for speed.

RNG: a GI parent draws its 2K sampling angles from the per-pixel PCG32
stream in-order, but children get forked streams (rng.derive) — the
reference's depth-first draw order cannot be reproduced breadth-first
(a child's stream position would depend on its siblings' subtree sizes).
No committed golden exercises GI, so this changes no parity result.
"""

from __future__ import annotations

import functools
import math
import os
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from crt_tpu.ops import rng as rng_mod
from crt_tpu.ops import vecmath
from crt_tpu.ops.intersect import Hit
from crt_tpu.ops.shade import (
    _occlusion_masks,
    hit_attributes,
    lane_partition,
    light_lum,
)
from crt_tpu.ops.texture import sample_textures
from crt_tpu.scene.types import (
    MATERIAL_CONSTANT,
    MATERIAL_DIFFUSE,
    MATERIAL_REFLECTIVE,
    MATERIAL_REFRACTIVE,
)

_PI = math.pi

# Lane-compact the pool's bounce traces by occupancy (see
# shade.lane_partition): within an occupied bank the live lanes (refractive
# continuations, Fresnel-pair children) are SCATTERED through the pixel
# tiles, so binning's tile_any skip drops nothing; packing them first turns
# sparsity into dead tiles.  Trace-only — the Hit is un-permuted before
# shading, so downstream masking semantics are untouched.  The full-width
# permute gathers are the cost; not yet measured on the GPU, so default
# OFF, opt-in flag.  Bit-exact (tests/test_lane_compact.py).
_POOL_COMPACT = os.environ.get("CRT_POOL_COMPACT", "0") != "0"


def default_banks(scene, settings) -> int:
    """Pool bank count.

    GI scenes get the EXACT Whitted-tree width f^D (f = per-parent fanout,
    max of K diffuse children and the refractive pair): a parent at level b
    occupies bank index < f^(b+1) under the lowest-free-slot packer (see
    the bank-growth bound in shade_wavefront_iter_with_stats), so f^D
    banks evaluate the full recursion with ZERO drops — round-3 measured
    the old heuristic (2^min(D,3) + 2(K+1) = 18 on the 15-01 showcase)
    dropping 10.6 M children and losing 1-4 % radiance vs converged.
    Bank-growth scheduling makes exactness affordable: total traced lanes
    are sum_b f^b (the true tree size), vs B*(D+1) for the scan.

    Non-GI refractive scenes keep the 2^min(D,3) cap: beyond depth 3 the
    Fresnel tree is weight-starved (round-2: 146 dropped paths = 0.0008 %
    of pixels off at depth 5 on 11-01-scene8) and exactness there would
    4x the pool for sub-noise gains — raise wavefront_banks to override.
    """
    if settings.wavefront_banks:
        return int(settings.wavefront_banks)
    D = settings.max_ray_depth
    if scene.gi_on:
        f = 1
        if scene.has_refractive and scene.refractions_on:
            f = 2
        K = settings.diffuse_reflection_ray_count
        if K > 1:
            f = max(f, K)
        return max(2, f**D)
    banks = 2 ** min(D, 3)
    if not (scene.has_refractive and scene.refractions_on):
        banks = min(banks, 2)
    return max(banks, 2)


class _Pool(NamedTuple):
    """Scan carry: the ray pool.  All leading dims [B, R]."""

    o: jnp.ndarray  # [B, R, 3] origins
    d: jnp.ndarray  # [B, R, 3] directions
    w: jnp.ndarray  # [B, R, 3] path throughput
    act: jnp.ndarray  # [B, R] bool
    acc: jnp.ndarray  # [B, R, 3] accumulated radiance (elementwise!)
    rng: Optional[rng_mod.PCGState]  # [B, R] planes, or None when GI off
    dropped: jnp.ndarray  # [] i32 children lost to pool overflow


def _place_children(pool_fields, dead, cand_act, cand_fields, dropped):
    """Place per-lane spawned children into free banks of their own column.

    ``dead [B, R]``: free slots.  ``cand_act [B, R]``: parent lanes (bank i,
    column p) spawning one child each into column p.  Children fill free
    slots in bank order; overflow children are dropped (counted).

    Returns (new_fields, new_dead, new_act_bits [B, R], dropped).
    """
    # rank of each free slot / each child within its column.  Source and
    # destination bank counts may differ (bank-growth scheduling grows the
    # pool between shading and placement).
    B = cand_act.shape[0]  # source banks
    dead_rank = jnp.cumsum(dead, axis=0) - 1  # [Bj, R]
    spawn_rank = jnp.cumsum(cand_act, axis=0) - 1  # [Bi, R]
    # match[i, j, p]: child from bank i lands in free bank j of column p
    match = (
        cand_act[:, None, :]
        & dead[None, :, :]
        & (spawn_rank[:, None, :] == dead_rank[None, :, :])
    )  # [Bi, Bj, R]
    has_src = match.any(axis=0)  # [B, R] destination receives a child
    placed = jnp.sum(has_src, dtype=jnp.int32)
    spawned = jnp.sum(cand_act, dtype=jnp.int32)
    dropped = dropped + (spawned - placed)

    # Exact select-accumulation over source banks: at most one source bank
    # matches a (dst, column) slot, so iterating i with where-overwrite is
    # exact for EVERY dtype.  (An einsum here would be a dot: TF32
    # for f32 fields by default, and integer dots may lower through
    # float — either silently corrupts child ray data / uint32 PCG states.
    # B is tiny, so B selects are cheap and fuse.)
    out = []
    for old, cand in zip(pool_fields, cand_fields):
        g = jnp.zeros_like(old)
        for i in range(B):
            m = match[i]  # [Bj, R]
            if old.ndim == 3:
                m = m[..., None]
            g = jnp.where(m, cand[i][None], g)
        mask = has_src if old.ndim == 2 else has_src[..., None]
        out.append(jnp.where(mask, g, old))
    return out, dead & ~has_src, has_src, dropped


def shade_wavefront_iter(
    scene,
    settings,
    trace_fn,
    origins: jnp.ndarray,  # [R, 3]
    dirs: jnp.ndarray,  # [R, 3]
    raster_x: Optional[jnp.ndarray] = None,
    raster_y: Optional[jnp.ndarray] = None,
    active: Optional[jnp.ndarray] = None,
    banks: Optional[int] = None,
    rows_fn=None,  # partitioned-scene row gather (see shade.hit_attributes)
    vary_axes=(),  # shard_map axes to mark the pool varying over
    gi_salt: Optional[jnp.ndarray] = None,  # progressive-pass stream salt
) -> jnp.ndarray:
    """Shade a camera wavefront iteratively -> [R, 3] linear colors."""
    color, _ = shade_wavefront_iter_with_stats(
        scene, settings, trace_fn, origins, dirs, raster_x, raster_y,
        active, banks, rows_fn, vary_axes, gi_salt,
    )
    return color


def shade_wavefront_iter_with_stats(
    scene, settings, trace_fn, origins, dirs,
    raster_x=None, raster_y=None, active=None, banks=None, rows_fn=None,
    vary_axes=(), gi_salt=None,
):
    """Like shade_wavefront_iter but also returns the dropped-child count."""
    R = origins.shape[0]
    B = int(banks) if banks else default_banks(scene, settings)
    D = settings.max_ray_depth

    if active is None:
        active = jnp.ones((R,), bool)

    if scene.gi_on:
        assert raster_x is not None and raster_y is not None, (
            "GI needs raster coords for per-pixel PCG32 seeding"
        )
        seed = rng_mod.make_pcg(raster_x, raster_y)
        seed = rng_mod.salt_stream(seed, gi_salt)
    else:
        seed = None

    def _vary(x):
        # Inside shard_map the pool carry types carry varying-manual-axes:
        # constant-built fields (w/act/acc/dropped, growth pads) would be
        # "unvarying" while the bounce output is varying over the caller's
        # mesh axes — align explicitly (fields already varying, like o/d
        # built from the sharded rays, are left alone).
        if not vary_axes:
            return x
        vma = getattr(getattr(x, "aval", None), "vma", frozenset())
        missing = tuple(a for a in vary_axes if a not in vma)
        return jax.lax.pcast(x, missing, to="varying") if missing else x

    want_refract = scene.has_refractive and scene.refractions_on
    want_reflect = scene.has_reflective and scene.reflections_on
    K = settings.diffuse_reflection_ray_count
    gi_scale = (
        1.0 / (K + 1)
        if (scene.gi_on or settings.gi_divide)
        else 1.0
    )

    # Bank-growth scheduling: per parent lane one bounce produces at most
    #   (continuations + spawned children) <= f
    # slots in its column (diffuse+GI: K children, parent dies; refractive:
    # Fresnel pair = continuation + 1; reflective: continuation), and the
    # packer fills the lowest free banks first, so after bounce b every
    # occupied bank index is < min(B, f^(b+1)).  Growing the pool 1 -> f ->
    # f^2 -> B instead of carrying all B banks skips the dead banks' trace
    # lanes and bookkeeping entirely — drop behavior is IDENTICAL (a child
    # only overflows when it would overflow the full-B pool too).
    grow_f = 1
    if want_refract:
        grow_f = 2
    if scene.gi_on and K > 1:
        grow_f = max(grow_f, K)

    def shade_local(o, d, act):
        """Trace + LOCAL (terminal) radiance of a flat wavefront.

        Returns (contrib [C,3], attrs, albedo, masks) — exactly what a ray
        at max depth contributes: background on miss, constant albedo,
        reflective albedo when reflections are off, direct diffuse
        lighting; reflective/refractive otherwise contribute black
        (their children would shade at depth+1 -> black,
        crt_renderer.cpp:47-48).
        """
        C = (o.shape[0],)
        if _POOL_COMPACT and not scene.gi_on and not vary_axes:
            # Occupancy compaction around the trace only: inactive lanes'
            # hit values are garbage either way (masked by ``act`` below),
            # so permuting changes no consumed output.  GI pools keep their
            # near-full occupancy — compaction would be pure overhead.
            pos, perm = lane_partition(act)
            hit_c = trace_fn(o[perm], d[perm], act[perm])
            hit = Hit(t=hit_c.t[pos], tri=hit_c.tri[pos])
        else:
            hit = trace_fn(o, d, act)
        attrs = hit_attributes(scene, o, d, hit, rows_fn=rows_fn)
        valid = attrs.valid & act
        miss = act & ~attrs.valid

        albedo = sample_textures(
            scene, attrs.albedo_tex, attrs.uv, attrs.bary_u, attrs.bary_v
        )
        is_diffuse = valid & (attrs.mat_type == MATERIAL_DIFFUSE)
        is_reflective = valid & (attrs.mat_type == MATERIAL_REFLECTIVE)
        is_refractive = valid & (attrs.mat_type == MATERIAL_REFRACTIVE)
        is_constant = valid & (attrs.mat_type == MATERIAL_CONSTANT)

        contrib = jnp.where(
            miss[..., None],
            jnp.broadcast_to(scene.background_color, C + (3,)),
            0.0,
        )
        if scene.has_constant:
            contrib = jnp.where(is_constant[..., None], albedo, contrib)
        if scene.has_reflective and not scene.reflections_on:
            # reflections disabled: reflective shades as plain albedo (:106)
            contrib = jnp.where(is_reflective[..., None], albedo, contrib)

        if scene.num_lights > 0:
            illuminated, light_dir, r2 = _occlusion_masks(
                scene, trace_fn, attrs.point, attrs.normal,
                scene.light_position,
                settings.shadow_bias, settings.no_shadows,
                shadow_active=is_diffuse,
                max_ray_depth=settings.max_ray_depth,
                refraction_bias=settings.refraction_bias,
                rows_fn=rows_fn,
            )
            # albedo factored out of the light sum (see shade.py): the
            # per-light accumulation runs on [Ll, R] scalars, not [Ll, R, 3].
            if settings.fused_light_vjp:
                lum = light_lum(
                    attrs.point, attrs.normal, scene.light_position,
                    scene.light_intensity, illuminated,
                )
            else:
                cos_law = jnp.maximum(
                    0.0, vecmath.dot(light_dir, attrs.normal[None])
                )
                sphere_area = 4.0 * _PI * r2
                lum = jnp.sum(
                    jnp.where(
                        illuminated,
                        scene.light_intensity[:, None] / sphere_area * cos_law,
                        0.0,
                    ),
                    axis=0,
                )
            direct = albedo * lum[..., None]
            contrib = jnp.where(
                is_diffuse[..., None], direct * gi_scale, contrib
            )
        masks = (is_diffuse, is_reflective, is_refractive)
        return contrib, attrs, albedo, masks

    def bounce(pool, grow_to=None, last=False, leaf_children=False):
        """One wavefront bounce.

        ``grow_to``: pad the pool to this many banks between shading and
        child placement (bank-growth scheduling).  ``last``: terminal
        bounce — children would shade at depth > max_ray_depth and return
        black (crt_renderer.cpp:47-48), so all continuation/spawn work is
        skipped and only local radiance accumulates.  ``leaf_children``:
        this bounce's children are LEAVES (depth == max_ray_depth) —
        evaluate their radiance inline (trace + shade_local, weighted into
        acc) instead of growing the pool and placing them: the pool never
        materializes the f^D-wide final tree level, only f^(D-1) banks.
        """
        Bc = pool.o.shape[0]
        C = (Bc * R,)

        def flat(x):
            return x.reshape((Bc * R,) + x.shape[2:])

        def unflat(x):
            return x.reshape((Bc, R) + x.shape[1:])

        o, d, act = flat(pool.o), flat(pool.d), flat(pool.act)
        w = flat(pool.w)

        contrib, attrs, albedo, (is_diffuse, is_reflective, is_refractive) \
            = shade_local(o, d, act)
        normal = attrs.normal
        point = attrs.point

        acc = pool.acc + unflat(w * contrib)

        if last:
            # terminal bounce: every child/continuation would shade at
            # depth > max_ray_depth -> black; skip ALL spawn bookkeeping,
            # continuation geometry and RNG draws (radiance-identical).
            return pool._replace(act=jnp.zeros_like(pool.act), acc=acc)

        # ---- refractive geometry (feeds both children) ----------------
        if want_refract:
            d_dot_n = vecmath.dot(d, normal)
            exiting = d_dot_n > 0.0
            refr_normal = jnp.where(exiting[..., None], -normal, normal)
            outside_ior = jnp.where(exiting, attrs.ior, 1.0)
            inside_ior = jnp.where(exiting, 1.0, attrs.ior)
            refr_dir, refr_ok = vecmath.refract(
                d, refr_normal, outside_ior, inside_ior
            )
            refr_origin = point - refr_normal * settings.refraction_bias
            # fresnel about the (possibly flipped) normal (:130)
            fresnel = 0.5 * jnp.power(
                1.0 + vecmath.dot(d, refr_normal), 5.0
            )[..., None]
            refl_r_dir = vecmath.reflect(d, refr_normal)
            refl_r_origin = point + refr_normal * settings.reflection_bias

        # ---- in-place continuation ------------------------------------
        # reflective lanes -> mirror ray, weight *= albedo (typo-gated);
        # refractive lanes -> refraction ray (weight *= 1-fresnel), or the
        # full-weight reflection on total internal reflection.
        new_o, new_d, new_w = o, d, w
        cont = jnp.zeros(C, bool)
        if want_reflect:
            # albedo with the Hadamard-* typo folded in: (a (*) c) == a' * c
            # with a'.y = a.y^2 (crt_vector.h:77)
            albedo_eff = albedo
            if settings.hadamard_y:
                albedo_eff = albedo.at[..., 1].multiply(albedo[..., 1])
            m = is_reflective[..., None]
            new_o = jnp.where(m, point + normal * settings.reflection_bias,
                              new_o)
            new_d = jnp.where(m, vecmath.reflect(d, normal), new_d)
            new_w = jnp.where(m, w * albedo_eff, new_w)
            cont = cont | is_reflective
        if want_refract:
            go_refr = is_refractive & refr_ok
            go_tir = is_refractive & ~refr_ok
            m = go_refr[..., None]
            new_o = jnp.where(m, refr_origin, new_o)
            new_d = jnp.where(m, refr_dir, new_d)
            new_w = jnp.where(m, w * (1.0 - fresnel), new_w)
            m = go_tir[..., None]
            new_o = jnp.where(m, refl_r_origin, new_o)
            new_d = jnp.where(m, refl_r_dir, new_d)
            # TIR: all weight stays on the reflection branch (:131-134)
            cont = cont | is_refractive

        rng = pool.rng
        have_rng = rng is not None

        # GI sample directions + forked child streams are computed BEFORE
        # placement so the parent's post-draw stream state can be committed
        # to the pool first — placements then overwrite dying parents' slots
        # with child state without being clobbered.
        gi_children = []
        if scene.gi_on:
            # local basis from (ray, normal) — crt_renderer.cpp:62-66
            right = vecmath.safe_normalize(vecmath.cross(d, normal))
            up = normal
            forward = vecmath.cross(right, up)
            local_m = vecmath.from_axes(right, up, forward)
            gi_origin = point + normal * settings.diffuse_reflection_bias
            r_flat = rng_mod.PCGState(*(flat(p) for p in rng))
            for k in range(K):
                u1, r_flat = rng_mod.uniform(r_flat, is_diffuse)
                angle_xy = _PI * u1
                gi_dir = jnp.stack(
                    [jnp.cos(angle_xy), jnp.sin(angle_xy),
                     jnp.zeros_like(angle_xy)], axis=-1,
                )
                u2, r_flat = rng_mod.uniform(r_flat, is_diffuse)
                angle_xz = 2.0 * _PI * u2
                c, s = jnp.cos(angle_xz), jnp.sin(angle_xz)
                x, z = gi_dir[..., 0], gi_dir[..., 2]
                gi_dir = jnp.stack(
                    [x * c + z * s, gi_dir[..., 1], -x * s + z * c], axis=-1
                )
                gi_dir = vecmath.rotate_rows(gi_dir, local_m)
                gi_children.append(
                    (gi_dir, rng_mod.derive(r_flat, k + 1))
                )
            rng = rng_mod.PCGState(*(unflat(p) for p in r_flat))

        if leaf_children:
            # Children are depth-D leaves: fold their radiance in directly
            # (one masked trace + local shade each), never materializing
            # the f^D-wide final tree level in the pool.  Bank starvation
            # cannot drop them — they are not placed.
            leaf = jnp.zeros(C + (3,), jnp.float32)
            if want_refract:
                c, *_ = shade_local(
                    refl_r_origin, refl_r_dir, is_refractive & refr_ok
                )
                leaf = leaf + (w * fresnel) * c
            for gi_dir, _child_rng in gi_children:
                c, *_ = shade_local(gi_origin, gi_dir, is_diffuse)
                leaf = leaf + (w * jnp.float32(gi_scale)) * c
            return _Pool(
                o=unflat(new_o), d=unflat(new_d), w=unflat(new_w),
                act=unflat(cont), acc=acc + unflat(leaf),
                rng=rng, dropped=pool.dropped,
            )

        pool_fields = [unflat(new_o), unflat(new_d), unflat(new_w)]
        if have_rng:
            pool_fields += list(rng)
        dead = ~unflat(cont)
        act2 = unflat(cont)
        dropped = pool.dropped
        acc_out = acc

        if grow_to is not None and grow_to > Bc:
            # bank-growth: append fresh dead banks for this bounce's
            # children.  Pad VALUES are never consumed (dead lanes are
            # masked everywhere); d gets a unit vector so normalize-style
            # math stays finite.
            pad = grow_to - Bc

            def padb(x, fill):
                p = jnp.full((pad,) + x.shape[1:], fill, x.dtype)
                return jnp.concatenate([x, _vary(p)], axis=0)

            pool_fields[0] = padb(pool_fields[0], 0.0)
            d_pad = jnp.broadcast_to(
                jnp.asarray([0.0, 0.0, -1.0], jnp.float32),
                (pad, R, 3),
            )
            pool_fields[1] = jnp.concatenate(
                [pool_fields[1], _vary(d_pad)], axis=0
            )
            pool_fields[2] = padb(pool_fields[2], 0.0)
            if have_rng:
                for j in range(3, 3 + 4):
                    pool_fields[j] = padb(pool_fields[j], 0)
            dead = padb(dead, True)
            act2 = padb(act2, False)
            acc_out = padb(acc, 0.0)

        # ---- spawned children -----------------------------------------
        def spawn(cand_act, co, cd, cw, crng, pool_fields, dead, act2,
                  dropped):
            cand_fields = [unflat(co), unflat(cd), unflat(cw)]
            if have_rng:
                cand_fields += [unflat(p) for p in crng]
            pool_fields, dead, placed, dropped = _place_children(
                pool_fields, dead, unflat(cand_act), cand_fields, dropped
            )
            return pool_fields, dead, act2 | placed, dropped

        if want_refract:
            # the Fresnel pair's reflection ray (weight *= fresnel); forked
            # stream so the two subtrees' GI draws decorrelate
            refl_rng = (
                rng_mod.derive(rng_mod.PCGState(*(flat(p) for p in rng)), 97)
                if have_rng else None
            )
            pool_fields, dead, act2, dropped = spawn(
                is_refractive & refr_ok,
                refl_r_origin, refl_r_dir, w * fresnel,
                refl_rng, pool_fields, dead, act2, dropped,
            )

        for gi_dir, child_rng in gi_children:
            pool_fields, dead, act2, dropped = spawn(
                is_diffuse, gi_origin, gi_dir,
                w * jnp.float32(gi_scale), child_rng,
                pool_fields, dead, act2, dropped,
            )

        new_rng = (
            rng_mod.PCGState(*pool_fields[3:7]) if have_rng else None
        )
        return _Pool(
            o=pool_fields[0], d=pool_fields[1], w=pool_fields[2],
            act=act2, acc=acc_out, rng=new_rng, dropped=dropped,
        )

    sched = getattr(settings, "wavefront_sched", "auto")
    use_grow = sched == "grow" or (sched == "auto" and scene.gi_on)

    def init_pool(nbanks):
        rng_b = (
            rng_mod.PCGState(
                *(jnp.broadcast_to(p[None], (nbanks, R)) for p in seed)
            )
            if scene.gi_on else None
        )
        p = _Pool(
            o=jnp.broadcast_to(origins[None], (nbanks, R, 3)),
            d=jnp.broadcast_to(dirs[None], (nbanks, R, 3)),
            w=jnp.ones((nbanks, R, 3), jnp.float32),
            act=jnp.zeros((nbanks, R), bool).at[0].set(active),
            acc=jnp.zeros((nbanks, R, 3), jnp.float32),
            rng=rng_b,
            dropped=jnp.zeros((), jnp.int32),
        )
        return jax.tree.map(_vary, p) if vary_axes else p

    if use_grow:
        # Unrolled bounce loop with a growing pool: D+1 distinct compiled
        # bodies (vs the scan's one) buy skipping every dead bank's trace
        # lanes and bookkeeping — GI cost is ~linear in pool banks.
        pool = init_pool(1)
        L = 1
        for b in range(D + 1):
            is_last = b == D
            leaf = b == D - 1  # children of this bounce are depth-D leaves
            g = L if (is_last or leaf) else min(B, L * grow_f)
            step = jax.checkpoint(
                functools.partial(
                    bounce, grow_to=g, last=is_last, leaf_children=leaf
                )
            )
            pool = step(pool)
            L = max(L, g)
        return pool.acc.sum(axis=0), pool.dropped

    pool = init_pool(B)
    scan_bounce = jax.checkpoint(
        lambda p, _idx: (bounce(p), None)
    )  # O(1)-residual backward per bounce
    pool, _ = jax.lax.scan(scan_bounce, pool, jnp.arange(D + 1))

    return pool.acc.sum(axis=0), pool.dropped
