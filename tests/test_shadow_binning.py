"""Shadow binning (pallas_trace.bin_apex_shared) + the w-form occlusion
kernel (interpret mode on CPU) vs a dense, unbinned evaluation of the same
test.

The shadow path bins each pixel tile by the light-side shaft (slab + cone
+ wedge, culling clusters entirely beyond the light) and walks only the
admitted clusters.  Binning only ever drops clusters no active segment can
reach, so the occlusion bits must be IDENTICAL to testing every triangle
(crt_renderer.cpp:81-96 semantics in the w parameterisation: occluded iff
some triangle is hit at 0 <= s <= 1 along w = light - point).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from crt_tpu.ops import camera as camera_ops
from crt_tpu.ops.intersect import PARALLEL_EPS
from crt_tpu.ops.pallas_trace import (
    TILE_RAYS,
    bin_apex_shared,
    bin_rays,
    build_cluster_tables,
    make_pallas_trace_fn,
)
from crt_tpu.scene.procedural import make_test_scene


@pytest.fixture(scope="module")
def setup():
    # 64x64 pixels -> 16 tiles of TILE_RAYS after the pixel tiler.
    scene = make_test_scene(width=64, height=64, num_quads=14,
                            with_reflective=False)
    trace = make_pallas_trace_fn(scene, interpret=True)
    from crt_tpu.renderer import make_tiler

    rx, ry, _ = make_tiler(scene.height, scene.width)
    o, d = camera_ops.generate_rays(
        scene.cam_position, scene.cam_rotation, scene.cam_tan_half_fov,
        scene.width, scene.height, rx, ry,
    )
    hit = trace(o, d)
    valid = np.asarray(hit.tri) >= 0
    assert valid.any() and (~valid).any()

    # shadow origins at the (geometric) hit points, biased along the ray
    # toward the camera — close enough to the real shading setup for parity.
    t = jnp.where(hit.tri >= 0, hit.t, 0.0)
    point = o + d * t[:, None]
    shadow_o = point - d * 1e-2
    return scene, trace, point, shadow_o, jnp.asarray(valid)


def _dense_w(scene, point, shadow_o, lp, act, capped=True, glass_only=False):
    """Every triangle against every lane, same arithmetic as the kernel."""
    from crt_tpu.scene.types import MATERIAL_REFRACTIVE

    tb = build_cluster_tables(scene)
    n = tb.n.reshape(-1, 3)
    nv0 = tb.nv0.reshape(-1)
    m = tb.m.reshape(-1, 9)
    c = tb.c.reshape(-1, 3)
    nobf = tb.nobf.reshape(-1)
    o = shadow_o[None, :, None, :]  # [1, R, 1, 3]
    w = (lp[:, None, :] - point[None])[:, :, None, :]  # [Ll, R, 1, 3]

    def dot3(a, v):
        return a[:, 0] * v[..., 0] + a[:, 1] * v[..., 1] + a[:, 2] * v[..., 2]

    nd = dot3(n, w)
    opd = nv0 - dot3(n, o)
    not_parallel = jnp.abs(nd) >= PARALLEL_EPS
    t = opd / jnp.where(not_parallel, nd, 1.0)
    ok = not_parallel & ((opd < 0.0) | (nobf > 0.5)) & (t >= 0.0)
    for e in range(3):
        me = m[:, 3 * e:3 * e + 3]
        ok = ok & ((dot3(me, o) - c[:, e]) + t * dot3(me, w) >= 0.0)
    if capped:
        ok = ok & (t <= 1.0)
    if glass_only:
        ids = jnp.maximum(tb.tri_id.reshape(-1), 0)
        glass = (scene.mat_type[scene.tri_material] == MATERIAL_REFRACTIVE)[ids]
        ok = ok & glass & (tb.tri_id.reshape(-1) >= 0)
    return np.asarray(ok.any(-1)) & np.asarray(act)


@pytest.mark.parametrize("lanes", ["all", "stripes", "first_quarter", "none"])
def test_shadow_apex_w_matches_dense(setup, lanes):
    """Binned kernel == dense test on every consumed lane, for full, striped,
    mostly-dead (dead tiles bin to empty lists) and empty wavefronts."""
    scene, trace, point, shadow_o, valid = setup
    lp = scene.light_position
    R = point.shape[0]
    keep = {
        "all": jnp.ones(R, bool),
        "stripes": jnp.arange(R) % 3 != 0,
        "first_quarter": jnp.arange(R) < R // 4,
        "none": jnp.zeros(R, bool),
    }[lanes]
    act = jnp.broadcast_to((valid & keep)[None], (lp.shape[0], R))
    ref = _dense_w(scene, point, shadow_o, lp, act)
    got = np.asarray(trace.shadow_apex_w(point, shadow_o, lp, act, 2e-2))
    a = np.asarray(act)
    np.testing.assert_array_equal(got[a], ref[a])
    if lanes == "all":
        # the scene must exercise both outcomes for the test to mean anything
        assert ref[a].any() and (~ref[a]).any()


def test_beyond_light_culling_is_occlusion_exact(setup):
    """Geometry strictly beyond the light must not occlude — and the t-cap
    culling that drops it must not flip any mask.  A light very close to
    the camera puts most scene geometry beyond it."""
    scene, trace, point, shadow_o, valid = setup
    light_positions = jnp.asarray(
        [np.asarray(scene.cam_position) + np.array([0.0, 0.1, 0.0])],
        jnp.float32,
    )
    act = valid[None]
    ref = _dense_w(scene, point, shadow_o, light_positions, act)
    got = np.asarray(trace.shadow_apex_w(point, shadow_o, light_positions,
                                         act, 2e-2))
    a = np.asarray(act)
    np.testing.assert_array_equal(got[a], ref[a])


def test_shadow_bins_cull_beyond_light():
    """Clusters strictly beyond the light along every tile segment must be
    culled (t-cap), while occlusion masks stay exact — synthetic scene with
    the whole quad field BEHIND the light as seen from the shadow origins."""
    scene = make_test_scene(width=64, height=64, num_quads=200,
                            with_reflective=False)
    tables = build_cluster_tables(scene)
    trace = make_pallas_trace_fn(scene, interpret=True)

    R = TILE_RAYS
    rng = np.random.default_rng(3)
    # shadow origins on a small patch near the camera; light just in front
    # of them; the whole quad field (z in [-3, -9]) sits beyond the light.
    point = jnp.asarray(rng.uniform(-0.5, 0.5, (R, 3)).astype(np.float32))
    light = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    act = jnp.ones((1, R), bool)

    got = np.asarray(trace.shadow_apex_w(point, point, light, act, 0.0))
    ref = _dense_w(scene, point, point, light, act)
    np.testing.assert_array_equal(got, ref)
    assert not ref.any()  # nothing between the origins and the light

    _, counts = bin_apex_shared(tables, point, light, act, TILE_RAYS, 0.0)
    L = tables.n.shape[0]
    assert L > 4  # enough clusters for culling to be observable
    assert int(counts.max()) < L // 2


def test_apex_bins_cover_segment_oracle(setup):
    """Every cluster some ACTIVE ray's segment [origin, light] actually
    slab-intersects must survive the apex cull (conservativeness), and the
    apex lists must not be larger than the generic frustum's."""
    scene, trace, point, shadow_o, valid = setup
    tables = build_cluster_tables(scene)
    cl_min = np.asarray(tables.cl_min)
    cl_max = np.asarray(tables.cl_max)

    P = np.asarray(scene.light_position)[:1]
    R = shadow_o.shape[0]
    o = np.asarray(shadow_o)
    lv = P - o
    r = np.sqrt((lv * lv).sum(-1))
    d = lv / np.maximum(r, 1e-30)[:, None]
    act = np.asarray(valid)

    slack = 2e-2
    cl_apex, cnt_apex = bin_apex_shared(
        tables, shadow_o, jnp.asarray(P), jnp.asarray(act)[None], TILE_RAYS,
        slack,
    )
    cl_gen, cnt_gen = bin_rays(
        tables, jnp.asarray(o), jnp.asarray(d), TILE_RAYS, jnp.asarray(act)
    )
    cnt_apex = np.asarray(cnt_apex)
    cnt_gen = np.asarray(cnt_gen)
    assert (cnt_apex <= cnt_gen).all()

    # oracle per tile: clusters any active ray's [o, P] segment slab-hits
    tiles = R // TILE_RAYS
    cl_apex = np.asarray(cl_apex)
    for ti in range(tiles):
        sl = slice(ti * TILE_RAYS, (ti + 1) * TILE_RAYS)
        o_t, d_t, a_t, r_t = o[sl], d[sl], act[sl], r[sl]
        if not a_t.any():
            continue
        inv = 1.0 / np.where(np.abs(d_t) > 1e-30, d_t, 1e-30)
        t0 = (cl_min[:, None, :] - o_t[None]) * inv[None]
        t1 = (cl_max[:, None, :] - o_t[None]) * inv[None]
        tn = np.minimum(t0, t1).max(-1)
        tf = np.maximum(t0, t1).min(-1)
        hit = (tf >= np.maximum(tn, 0.0)) & (tn <= r_t[None]) & a_t[None]
        needed = set(np.nonzero(hit.any(-1))[0].tolist())
        kept = set(cl_apex[ti, : cnt_apex[ti]].tolist())
        assert needed <= kept, (ti, needed - kept)


@pytest.mark.parametrize("seed", [0, 1])
def test_glass_router_matches_uncapped_gate(seed):
    """The merged one-pass router (shadow_apex_w_glass) must report the
    same occlusion bits as the plain w pass and the same glass bits as the
    separate uncapped gate (refr_ray_hit_w), which in turn match a dense
    uncapped glass-member test."""
    from crt_tpu.renderer import make_tiler

    scene = make_test_scene(width=64, height=32, num_quads=10, seed=seed,
                            with_refractive=True)
    trace = make_pallas_trace_fn(scene, interpret=True)
    rx, ry, _ = make_tiler(scene.height, scene.width)
    o, d = camera_ops.generate_rays(
        scene.cam_position, scene.cam_rotation, scene.cam_tan_half_fov,
        scene.width, scene.height, rx, ry,
    )
    hit = trace(o, d)
    point = o + d * jnp.where(hit.tri >= 0, hit.t, 0.0)[:, None]
    shadow_o = point - d * 1e-2
    lp = scene.light_position
    act = jnp.broadcast_to((hit.tri >= 0)[None], (lp.shape[0], o.shape[0]))

    occ, glass = trace.shadow_apex_w_glass(point, shadow_o, lp, act, 2e-2)
    occ_plain = trace.shadow_apex_w(point, shadow_o, lp, act, 2e-2)
    gate = trace.refr_ray_hit_w(point, shadow_o, lp, act, 2e-2)
    a = np.asarray(act)
    np.testing.assert_array_equal(np.asarray(occ)[a], np.asarray(occ_plain)[a])
    np.testing.assert_array_equal(np.asarray(glass)[a], np.asarray(gate)[a])
    ref = _dense_w(scene, point, shadow_o, lp, act, capped=False,
                   glass_only=True)
    np.testing.assert_array_equal(np.asarray(gate)[a], ref[a])
    assert ref[a].any()


def test_full_line_slab_negative_t_regression():
    """Regression: the t_lo_clamp=False slab must use four-corner interval
    division — the one-corner t>=0 formulas INVERT per-axis [entry, exit]
    for boxes in the negative-t (beyond-the-light) region.  Exact
    counterexample from 11-01-scene8: tile origin box behind the light,
    glass cluster reachable at apex-t ~ -3, z-axis formula gave [-0.93,
    -4.44] and culled it (the transmissive-march gate then missed the glass
    and mis-shadowed the lane)."""
    from crt_tpu.ops.pallas_trace import _frustum_box_mask

    apex = jnp.asarray([[-9.0, 16.0, 0.0]], jnp.float32)
    o_lo = jnp.asarray([[-14.999211, 19.18162, -14.990004]], jnp.float32)
    o_hi = jnp.asarray([[-8.026135, 19.996952, -1.5759029]], jnp.float32)
    s = jnp.float32(2e-2)
    w_lo = (o_lo - s) - apex
    w_hi = (o_hi + s) - apex
    bmin = jnp.asarray([[-10.77794, 1.17625, 7.105974]], jnp.float32)
    bmax = jnp.asarray([[-4.336956, 5.924379, 14.02273]], jnp.float32)

    ok = _frustum_box_mask(
        apex, apex, w_lo, w_hi, bmin - 2 * s, bmax + 2 * s,
        t_cap=jnp.float32(1.0 + 1e-4), t_lo_clamp=False,
    )
    assert bool(ok[0, 0]), (
        "full-line slab culled a beyond-the-light box a real shadow ray "
        "reaches (f64-verified hit at t=20.4, |w|=4.78)"
    )

    # and the capped regime must still cull it (entry > 1 on the segment)
    ok_capped = _frustum_box_mask(
        apex, apex, w_lo, w_hi, bmin - 2 * s, bmax + 2 * s,
        t_cap=jnp.float32(1.0 + 1e-4),
    )
    assert not bool(ok_capped[0, 0])
