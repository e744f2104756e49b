"""Pallas cluster-walk kernel (Triton route, interpret mode on CPU) vs the
plain all-pairs reference, plus the wrapper's binning, padding and the
``auto`` backend choice."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from crt_tpu import RenderSettings, render_image
from crt_tpu.ops import camera as camera_ops
from crt_tpu.ops import intersect
from crt_tpu.ops import pallas_trace as pt
from crt_tpu.ops.pallas_trace import (
    bin_rays,
    build_cluster_tables,
    make_pallas_trace_fn,
)
from crt_tpu.scene.procedural import make_test_scene


@pytest.fixture(scope="module")
def scene():
    return make_test_scene(width=64, height=40, num_quads=12,
                           with_reflective=False)


def _camera_rays(scene):
    o, d = camera_ops.generate_rays(
        scene.cam_position, scene.cam_rotation, scene.cam_tan_half_fov,
        scene.width, scene.height,
    )
    return o.reshape(-1, 3), d.reshape(-1, 3)


def _bruteforce(scene, o, d):
    td = intersect.build_triangle_data(
        scene.vertices, scene.tri_vidx,
        scene.mat_backface[scene.tri_material],
    )
    return intersect.closest_hit_bruteforce(td, o, d)


def _assert_hits_match(ref, got, lanes=None):
    bt, bi = np.asarray(ref.t), np.asarray(ref.tri)
    pt_, pi = np.asarray(got.t), np.asarray(got.tri)
    if lanes is not None:
        bt, bi, pt_, pi = bt[lanes], bi[lanes], pt_[lanes], pi[lanes]
    assert ((bi < 0) == (pi < 0)).all()
    hits = bi >= 0
    np.testing.assert_allclose(pt_[hits], bt[hits], rtol=1e-5, atol=1e-6)
    # Disagreeing ids are exact-distance ties (shared-edge hits) where the
    # reference's first-wins rule depends on traversal order; verify ties.
    dis = hits & (pi != bi)
    assert dis.mean() < 0.005
    np.testing.assert_allclose(pt_[dis], bt[dis], rtol=1e-6, atol=1e-7)


def test_binning_covers_bruteforce_hits(scene):
    """Every ray's true hit cluster must be in its tile's compacted list."""
    tables = build_cluster_tables(scene)
    o, d = _camera_rays(scene)
    TILE_RAYS = pt.TILE_RAYS
    o = np.asarray(o)
    d = np.asarray(d)
    R = (len(o) // TILE_RAYS) * TILE_RAYS
    o, d = o[:R], d[:R]

    leaf_list, counts = jax.jit(bin_rays)(tables, jnp.asarray(o), jnp.asarray(d))
    leaf_list, counts = np.asarray(leaf_list), np.asarray(counts)

    # reference: exact per-ray slab test against each cluster AABB
    lmin = np.asarray(tables.cl_min)
    lmax = np.asarray(tables.cl_max)
    inv = 1.0 / np.where(np.abs(d) > 1e-30, d, 1e-30)
    t1 = (lmin[None, :] - o[:, None]) * inv[:, None]
    t2 = (lmax[None, :] - o[:, None]) * inv[:, None]
    tnear = np.minimum(t1, t2).max(-1)
    tfar = np.maximum(t1, t2).min(-1)
    ray_hits = tfar >= np.maximum(tnear, 0)  # [R, L]

    tiles = R // TILE_RAYS
    for ti in range(tiles):
        needed = set(
            np.nonzero(ray_hits[ti * TILE_RAYS : (ti + 1) * TILE_RAYS].any(0))[0]
        )
        got = set(leaf_list[ti, : counts[ti]].tolist())
        assert needed <= got, f"tile {ti}: missing leaves {needed - got}"


def test_pallas_interpret_matches_bruteforce(scene):
    o, d = _camera_rays(scene)
    trace = make_pallas_trace_fn(scene, interpret=True)
    _assert_hits_match(_bruteforce(scene, o, d), trace(o, d))


def test_full_render_pallas_interpret(scene, monkeypatch):
    brute = np.asarray(render_image(scene, RenderSettings(backend="bruteforce")))
    import crt_tpu.renderer as renderer

    orig = renderer.make_trace_fn

    def patched(scn, settings):
        if settings.backend == "pallas":
            return make_pallas_trace_fn(scn, interpret=True)
        return orig(scn, settings)

    monkeypatch.setattr(renderer, "make_trace_fn", patched)
    pal = np.asarray(
        render_image(scene, RenderSettings(backend="pallas"), jit=False)
    )
    np.testing.assert_allclose(pal, brute, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("pad", [0, 37])
@pytest.mark.parametrize("masked", [False, True])
def test_walk_matches_bruteforce(seed, pad, masked):
    """The walk over seeded scenes, with a ray count that is or is not a
    tile multiple (the wrapper pads with dead lanes) and with or without an
    active mask (masked lanes leave the frusta; consumed lanes must still
    match the reference)."""
    s = make_test_scene(width=32, height=16, num_quads=20, seed=seed,
                        with_reflective=False)
    o, d = _camera_rays(s)
    R = o.shape[0] - pad  # 512 rays = 2 tiles, or a ragged count
    o, d = o[:R], d[:R]
    act = (jnp.arange(R) % 5 != 0) if masked else None
    trace = make_pallas_trace_fn(s, interpret=True)
    got = trace(o, d, act)
    assert got.t.shape == (R,) and got.tri.shape == (R,)
    lanes = None if act is None else np.asarray(act)
    _assert_hits_match(_bruteforce(s, o, d), got, lanes)


def test_walk_batch_shape_preserved(scene):
    """Leading batch dims round-trip through the flat kernel."""
    o, d = _camera_rays(scene)
    trace = make_pallas_trace_fn(scene, interpret=True)
    flat = trace(o, d)
    batched = trace(o.reshape(4, -1, 3), d.reshape(4, -1, 3))
    assert batched.t.shape == (4, o.shape[0] // 4)
    np.testing.assert_array_equal(np.asarray(batched.tri).reshape(-1),
                                  np.asarray(flat.tri))


@pytest.mark.parametrize("density", [0.0, 0.1, 0.5, 1.0])
def test_compact_mask_matches_argsort(density):
    """The linear-time cluster-list compaction lists exactly the admitted
    clusters, in ascending order, with the right counts."""
    rng = np.random.default_rng(int(density * 10))
    mask = rng.random((6, 37)) < density
    lst, counts = pt.compact_mask(jnp.asarray(mask))
    lst, counts = np.asarray(lst), np.asarray(counts)
    np.testing.assert_array_equal(counts, mask.sum(1))
    for row in range(mask.shape[0]):
        np.testing.assert_array_equal(
            lst[row, : counts[row]], np.nonzero(mask[row])[0]
        )


def test_cluster_records_layout(scene):
    """The fused record holds every table field, field-major per cluster."""
    tables = build_cluster_tables(scene)
    rec = np.asarray(pt.cluster_records(tables))
    L, S = tables.tri_id.shape
    assert rec.shape == (L, pt.FIELDS, S)
    np.testing.assert_array_equal(rec[:, 0:3].swapaxes(1, 2), tables.n)
    np.testing.assert_array_equal(rec[:, 3], tables.nv0)
    np.testing.assert_array_equal(rec[:, 4:13].swapaxes(1, 2), tables.m)
    np.testing.assert_array_equal(rec[:, 13:16].swapaxes(1, 2), tables.c)
    np.testing.assert_array_equal(rec[:, 16], tables.nobf)
    np.testing.assert_array_equal(rec[:, 17].astype(np.int32), tables.tri_id)


def test_block_must_divide_tile(scene, monkeypatch):
    monkeypatch.setattr(pt, "BLOCK_RAYS", 96)
    o, d = _camera_rays(scene)
    with pytest.raises(ValueError, match="BLOCK_RAYS"):
        make_pallas_trace_fn(scene, interpret=True)(o, d)


@pytest.mark.parametrize("platform,expect", [
    ("gpu", "pallas"), ("cpu", "bruteforce"), ("unknown", None),
])
def test_auto_backend_choice(platform, expect, monkeypatch):
    """``auto`` is the kernel on the GPU, the plain reference on the CPU,
    and an error on any other platform; a named backend passes through."""
    from crt_tpu import renderer

    monkeypatch.setattr(renderer.jax, "default_backend", lambda: platform)
    assert renderer.resolve_backend("tree") == "tree"
    if expect is None:
        with pytest.raises(RuntimeError, match="no default"):
            renderer.resolve_backend("auto")
    else:
        assert renderer.resolve_backend("auto") == expect
