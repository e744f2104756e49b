"""Camera rig + debug ray logger tests."""

import math

import numpy as np
import jax.numpy as jnp
import pytest

from crt_tpu import RenderSettings, render_image
from crt_tpu.scene.procedural import make_test_scene
from crt_tpu.utils.camera_rig import CameraRig
from crt_tpu.utils.debug import trace_pixel


def test_camera_rig_moves():
    rig = CameraRig.identity((0.0, 0.0, 5.0))
    # dolly forward in local space (identity rotation: straight +z)
    rig2 = rig.dolly(-2.0)
    np.testing.assert_allclose(np.asarray(rig2.position), [0, 0, 3], atol=1e-6)

    # pan 90 degrees, then dolly: local -z is now world -x... row convention:
    rig3 = rig.pan(math.pi / 2).dolly(-1.0)
    # local (0,0,-1) @ rotation_y(90): x' = -(-1)*sin? verify orthonormality
    assert abs(np.linalg.norm(np.asarray(rig3.position) - np.asarray(rig.position)) - 1.0) < 1e-5

    # pan_around keeps distance to anchor
    anchor = jnp.asarray([1.0, 0.0, 0.0])
    rig4 = rig.pan_around(0.7, anchor)
    d_before = np.linalg.norm(np.asarray(rig.position - anchor))
    d_after = np.linalg.norm(np.asarray(rig4.position - anchor))
    np.testing.assert_allclose(d_after, d_before, rtol=1e-5)

    # rotations stay orthonormal under composition
    r = np.asarray(rig.pan(0.3).tilt(-0.2).roll(1.1).rotation)
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-5)


def test_buggy_compose_matches_cpp_inplace_loop():
    """buggy_compose must be bit-exact vs the reference operator*=
    (crt_matrix.h:45-54): in-place accumulation where the k == j read sees
    the partially updated data[i][j]."""

    def cpp_star_eq(data, rhs):
        data = np.array(data, np.float32)
        rhs = np.asarray(rhs, np.float32)
        for i in range(3):
            for j in range(3):
                for k in range(3):
                    data[i, j] += data[i, k] * rhs[k, j]
        return data

    rig = CameraRig.identity().pan(0.4)  # non-trivial starting rotation
    for angle in (0.3, -1.2):
        m = np.asarray(
            CameraRig.identity().pan(angle).rotation, np.float32
        )
        expected = cpp_star_eq(np.asarray(rig.rotation, np.float32), m)
        got = np.asarray(rig.pan(angle, buggy_compose=True).rotation)
        np.testing.assert_array_equal(got, expected)


def test_camera_rig_render_changes_view():
    scene = make_test_scene(width=24, height=16, num_quads=4)
    img0 = np.asarray(render_image(scene, RenderSettings()))
    rig = CameraRig.from_scene(scene).truck(2.0)
    img1 = np.asarray(render_image(rig.apply(scene), RenderSettings()))
    assert np.abs(img0 - img1).max() > 1e-3


def test_trace_pixel_records_rays():
    scene = make_test_scene(width=24, height=16, num_quads=4,
                            with_reflective=True)
    log = trace_pixel(scene, 12, 8)
    assert log.entries, "no rays recorded"
    # primary ray starts at the camera
    np.testing.assert_allclose(
        log.entries[0].origin, np.asarray(scene.cam_position), atol=1e-6
    )
    # color matches the full render at that pixel
    img = np.asarray(render_image(scene, RenderSettings()))
    np.testing.assert_allclose(log.color, img[8, 12], rtol=1e-4, atol=1e-5)

    script = log.to_blender_script()
    assert "bpy.ops.crt.debug_ray_add(" in script
    assert "raster_coords=(12, 8)" in script


@pytest.mark.parametrize("env_dir", [None, "/some/cache/dir"])
def test_compilation_cache_dir(env_dir, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR wins and the code sets no directory of its
    own; without it the cache lives at the fixed <checkout>/.jax_cache."""
    import os

    import jax

    from crt_tpu.utils import cache

    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    monkeypatch.setattr(os, "makedirs", lambda *a, **k: None)
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert cache.enable_compilation_cache() == os.path.join(
            checkout, ".jax_cache")
        assert updates["jax_compilation_cache_dir"] == cache.DEFAULT_DIR
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
        assert cache.enable_compilation_cache() == env_dir
        assert "jax_compilation_cache_dir" not in updates
