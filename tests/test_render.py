"""End-to-end render tests on small procedural scenes + gradient checks."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from crt_tpu import RenderSettings, render_image
from crt_tpu.scene.procedural import make_test_scene


@pytest.fixture(scope="module")
def scene():
    return make_test_scene(width=48, height=32, num_quads=6, with_reflective=True)


def test_render_shapes_and_finite(scene):
    img = np.asarray(render_image(scene, RenderSettings()))
    assert img.shape == (32, 48, 3)
    assert np.isfinite(img).all()
    assert img.min() >= 0.0
    # background must appear somewhere
    bg = np.asarray(scene.background_color)
    assert (np.abs(img - bg).max(-1) < 1e-6).any()


def test_backends_agree(scene):
    brute = np.asarray(render_image(scene, RenderSettings(backend="bruteforce")))
    tree = np.asarray(render_image(scene, RenderSettings(backend="tree")))
    mismatch = np.abs(brute - tree).max()
    assert mismatch < 1e-5, f"tree vs brute mismatch {mismatch}"


def test_head_compat_changes_output(scene):
    normal = np.asarray(render_image(scene, RenderSettings()))
    headc = np.asarray(render_image(scene, RenderSettings(head_compat=True)))
    # head_compat divides diffuse by 5 and disables shadows -> must differ
    assert np.abs(normal - headc).max() > 1e-3


def test_gradients_vertices_finite_differences():
    scene = make_test_scene(width=24, height=16, num_quads=3,
                            with_reflective=False)
    settings = RenderSettings()

    def loss(vertices):
        s = scene.replace(vertices=vertices)
        img = render_image(s, settings, jit=False)
        return jnp.sum(img * jnp.cos(jnp.arange(img.size).reshape(img.shape)))

    v0 = scene.vertices
    g = jax.grad(loss)(v0)
    assert np.isfinite(np.asarray(g)).all()
    assert float(jnp.abs(g).max()) > 0.0

    # directional finite difference on a random perturbation
    rng = np.random.default_rng(0)
    dv = jnp.asarray(rng.normal(size=v0.shape).astype(np.float32))
    eps = 1e-3
    f1 = float(loss(v0 + eps * dv))
    f2 = float(loss(v0 - eps * dv))
    fd = (f1 - f2) / (2 * eps)
    analytic = float(jnp.vdot(g, dv))
    # visibility edges make this noisy; demand the smooth part dominates
    assert abs(fd - analytic) < 0.12 * max(abs(fd), abs(analytic), 1.0), (
        f"fd={fd} analytic={analytic}"
    )


def test_gradients_flow_to_all_parameter_groups():
    scene = make_test_scene(width=16, height=12, num_quads=3)
    settings = RenderSettings()

    def loss_of(params):
        s = scene.replace(**params)
        return jnp.mean(render_image(s, settings, jit=False) ** 2)

    params = {
        "vertices": scene.vertices,
        "tex_color_a": scene.tex_color_a,
        "light_intensity": scene.light_intensity,
        "cam_position": scene.cam_position,
        "cam_rotation": scene.cam_rotation,
    }
    grads = jax.grad(loss_of)(params)
    for name, g in grads.items():
        g = np.asarray(g)
        assert np.isfinite(g).all(), name
        assert np.abs(g).sum() > 0, f"no gradient signal to {name}"


def test_pixel_tile_matches_binning_tile():
    """The renderer's pixel tile is the kernel's binning tile, and the
    tiler's ray order round-trips through untile."""
    import jax.numpy as jnp

    from crt_tpu.ops import pallas_trace
    from crt_tpu.renderer import TILE_H, TILE_W, make_tiler

    assert TILE_H * TILE_W == pallas_trace.TILE_RAYS
    assert pallas_trace.TILE_RAYS % pallas_trace.BLOCK_RAYS == 0
    rx, ry, untile = make_tiler(20, 35)
    img = untile(jnp.stack([rx, ry, rx * 0], -1))
    np.testing.assert_array_equal(np.asarray(img[..., 0])[3], np.arange(35))
    np.testing.assert_array_equal(np.asarray(img[..., 1])[:, 7], np.arange(20))
