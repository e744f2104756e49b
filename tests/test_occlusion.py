"""w-parameterised shadow occlusion kernel (interpret mode on CPU) vs the
plain normalised-direction reference."""

import numpy as np
import jax.numpy as jnp
import pytest

from crt_tpu.ops import camera as camera_ops
from crt_tpu.ops import vecmath
from crt_tpu.ops.pallas_trace import (
    build_cluster_tables,
    closest_hit_tables,
    make_pallas_trace_fn,
)
from crt_tpu.scene.procedural import make_test_scene


@pytest.fixture(scope="module")
def scene():
    return make_test_scene(width=64, height=48, num_quads=8,
                           with_reflective=False)


def _reference_occlusion(scene, shadow_o, lp, act):
    """Occluded iff the closest hit along the NORMALISED direction toward
    the light lies within the light distance (crt_renderer.cpp:81-96),
    evaluated densely in plain XLA at HIGHEST precision."""
    tables = build_cluster_tables(scene)
    Ll, R = act.shape
    lv = lp[:, None, :] - shadow_o[None]
    r2 = jnp.sum(lv * lv, -1)
    ldir = vecmath.safe_normalize(lv)
    o = jnp.broadcast_to(shadow_o[None], (Ll, R, 3)).reshape(-1, 3)
    sh = closest_hit_tables(tables, o, ldir.reshape(-1, 3))
    occ = (sh.tri >= 0) & (sh.t * sh.t <= r2.reshape(-1))
    return np.asarray(occ.reshape(Ll, R)) & np.asarray(act)


def test_shadow_apex_w_matches_apex(scene):
    """The w-parameterized occlusion (in-kernel directions, s <= 1) must
    agree with the normalized-direction (d̂) reference — the closest hit
    along d̂ within the light distance, evaluated densely — on every
    active lane up to boundary-rounding flips (the ray is identical; only
    the hit-test arithmetic's rounding differs)."""
    trace = make_pallas_trace_fn(scene, interpret=True)
    assert hasattr(trace, "shadow_apex_w")
    o, d = camera_ops.generate_rays(
        scene.cam_position, scene.cam_rotation, scene.cam_tan_half_fov,
        scene.width, scene.height,
    )
    o = o.reshape(-1, 3)
    d = d.reshape(-1, 3)
    hit = trace(o, d)
    t = jnp.where(jnp.isfinite(hit.t), hit.t, 2.0)
    point = o + d * t[:, None]
    R = point.shape[0]
    lp = scene.light_position
    Ll = lp.shape[0]
    act = ((jnp.arange(R) % 6) != 0)[None] & jnp.ones((Ll, R), bool) \
        & (hit.tri >= 0)[None]
    shadow_o = point + 1e-2 * vecmath.safe_normalize(point)

    base = _reference_occlusion(scene, shadow_o, lp, act)
    w = np.asarray(trace.shadow_apex_w(point, shadow_o, lp, act, 2e-2))
    lanes = np.asarray(act)
    assert base[lanes].any() and (~base[lanes]).any()
    dis = (w != base) & lanes
    assert dis.mean() < 0.005, dis.mean()

    # Every disagreeing lane must be a BOUNDARY lane: some triangle's f64
    # decision quantity sits at a flip point — either the documented
    # parallel-eps deviation (|n·d̂| below PARALLEL_EPS while |n·w| is
    # above: the w-kernel can register a grazing blocker the d̂-path drops)
    # or a quantity within rounding distance of its boundary (t ≈ 0,
    # t² ≈ r², edge half-space ≈ 0).  A tolerance-only bound would let a
    # real semantics regression hide under the flip-rate budget.
    from crt_tpu.ops.intersect import PARALLEL_EPS

    verts = np.asarray(scene.vertices, np.float64)
    tvi = np.asarray(scene.tri_vidx)
    v0, v1, v2 = verts[tvi[:, 0]], verts[tvi[:, 1]], verts[tvi[:, 2]]
    n_t = np.cross(v1 - v0, v2 - v0)
    n_t /= np.maximum(np.linalg.norm(n_t, axis=-1, keepdims=True), 1e-300)
    m_t = np.stack(
        [np.cross(n_t, v1 - v0), np.cross(n_t, v2 - v1),
         np.cross(n_t, v0 - v2)], axis=1,
    )  # [T, 3edges, 3]
    c_t = np.stack(
        [np.sum(m_t[:, 0] * v0, -1), np.sum(m_t[:, 1] * v1, -1),
         np.sum(m_t[:, 2] * v2, -1)], axis=1,
    )
    point_np = np.asarray(point, np.float64)
    so_np = np.asarray(shadow_o, np.float64)
    lp_np = np.asarray(lp, np.float64)
    REL = 1e-3  # f32 rounding across the two arithmetic orders

    for l, lane in zip(*np.nonzero(dis)):
        P = point_np[lane]
        ob = so_np[lane]
        wv = lp_np[l] - P
        wlen = np.linalg.norm(wv)
        dh = wv / wlen
        r2l = wlen * wlen
        nd_hat = n_t @ dh
        nd_w = n_t @ wv
        opd = np.sum(n_t * v0, -1) - n_t @ ob
        with np.errstate(divide="ignore", invalid="ignore"):
            t_hat = opd / nd_hat  # [T]
        edge = np.einsum("tej,j->te", m_t, ob) - c_t \
            + t_hat[:, None] * np.einsum("tej,j->te", m_t, dh)
        inside = (edge >= -REL * np.abs(c_t).max()).all(-1)
        hits_seg = inside & (t_hat >= -REL) & (t_hat * t_hat <= r2l * (1 + REL))
        eps_flip = hits_seg & (np.abs(nd_hat) < PARALLEL_EPS * (1 + REL)) \
            & (np.abs(nd_w) >= PARALLEL_EPS * (1 - REL))
        margin = np.minimum.reduce([
            np.abs(np.abs(nd_hat) - PARALLEL_EPS) / PARALLEL_EPS,
            np.abs(t_hat * t_hat - r2l) / r2l,
            np.abs(t_hat) / max(wlen, 1e-30),
            np.abs(edge).min(-1) / max(np.abs(c_t).max(), 1e-30),
        ])
        boundary = hits_seg & (margin < REL)
        assert eps_flip.any() or boundary.any(), (
            f"lane ({l},{lane}) disagrees but no triangle is at a decision "
            f"boundary — semantics regression?"
        )


def test_apex_w_parallel_eps_boundary_pinned():
    """Pin the w-kernel's documented parallel-eps deviation with a
    CONSTRUCTED grazing blocker.

    The kernel gates the parallel-ray test on |n·w| (unnormalized, w =
    light - point) where the reference and the d̂-path gate on |n·d̂|
    (crt_intersection.cpp:52) — stricter by |w|.  Geometry: a huge
    triangle in z=0, shadow segment grazing it with n·d̂ = 5e-7 (inside
    PARALLEL_EPS=1e-6 -> the d̂-path DROPS the blocker) but |w| = 1e3 so
    n·w = 5e-4 (outside -> the w-kernel REGISTERS it).  This is the
    committed, intended behavior; if a normalization change silently
    shifts the kernel's epsilon semantics, this test fails.
    """
    from crt_tpu.ops.pallas_trace import TILE_RAYS
    from crt_tpu.scene.json_loader import scene_from_dict

    data = {
        "settings": {"background_color": [0, 0, 0],
                     "image_settings": {"width": 32, "height": 32}},
        "camera": {"position": [0, 0, 5],
                   "matrix": [1, 0, 0, 0, 1, 0, 0, 0, 1]},
        "lights": [{"position": [0, 0, 10], "intensity": 100}],
        "materials": [{"type": "diffuse", "albedo": [1, 1, 1],
                       "smooth_shading": False}],
        "objects": [{"material_index": 0,
                     "vertices": [-10.0, -10.0, 0.0,
                                  10.0, -10.0, 0.0,
                                  0.0, 10.0, 0.0],
                     "triangles": [0, 1, 2]}],
    }
    s = scene_from_dict(data)
    trace = make_pallas_trace_fn(s, interpret=True)

    R = TILE_RAYS
    P0 = np.array([0.0, 0.0, -1e-9])
    dh = np.array([1.0, 0.0, 5e-7])
    dh /= np.linalg.norm(dh)
    lp = (P0 + 1e3 * dh)[None].astype(np.float32)  # |w| = 1e3

    point = jnp.asarray(np.tile(P0, (R, 1)), jnp.float32)
    shadow_o = point  # zero bias: the geometry is the boundary case itself
    act = jnp.zeros((1, R), bool).at[0, 0].set(True)
    wv = jnp.asarray(lp) - point
    ldir = vecmath.safe_normalize(jnp.asarray(lp)[:, None, :] - point[None])

    # sanity: the construction really straddles PARALLEL_EPS in f32
    n = np.array([0.0, 0.0, 1.0])
    nd_hat = float(np.asarray(ldir, np.float32)[0, 0] @ n)
    nd_w = float(np.asarray(wv, np.float32)[0] @ n)
    assert abs(nd_hat) < 1e-6 * 0.75, nd_hat
    assert abs(nd_w) > 1e-6 * 100, nd_w

    occ_hat = _reference_occlusion(s, shadow_o, jnp.asarray(lp), act)
    occ_w = np.asarray(trace.shadow_apex_w(
        point, shadow_o, jnp.asarray(lp), act, 1e-4
    )).reshape(-1)

    assert not occ_hat[0, 0], "d̂-path must DROP the sub-eps grazing blocker"
    assert occ_w[0], "w-kernel must REGISTER the grazing blocker (n·w > eps)"


def test_shadow_apex_w_ragged_wavefront_falls_back(scene):
    """A pixel count that is not a tile multiple cannot be apex-binned:
    the kernel path returns None and the caller takes the generic trace."""
    trace = make_pallas_trace_fn(scene, interpret=True)
    R = 100
    point = jnp.zeros((R, 3), jnp.float32)
    act = jnp.ones((scene.light_position.shape[0], R), bool)
    assert trace.shadow_apex_w(point, point, scene.light_position, act,
                               1e-3) is None
