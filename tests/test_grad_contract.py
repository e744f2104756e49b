"""Gradient contract (BASELINE.json): backward matches finite differences,
per parameter group, with quantified tolerances.

FD across visibility silhouettes is meaningless (the contract stops
gradients at discrete hit choices), so the sweep scene is a single large
quad covering the entire view: every pixel stays on the same triangle for
+/- eps, making every parameter's effect smooth.  Tolerances per group:

  light_intensity   1e-2  (image is linear in intensity; f32 FD noise only)
  tex_color_a       1e-2  (linear in albedo)
  vertices          3e-2  (normal/point/distance chains)
  cam_position      3e-2
  cam_rotation      3e-2

A second test differentiates through the *Pallas* intersection backend
(interpret mode on CPU) and demands identical gradients to the bruteforce
backend — same hit ids in, same differentiable recomputation out.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from crt_tpu import RenderSettings
from crt_tpu.ops import camera as camera_ops
from crt_tpu.ops.shade import shade_wavefront
from crt_tpu.renderer import make_tiler, make_trace_fn, render_image
from crt_tpu.scene.json_loader import scene_from_dict


def _wall_scene(width=24, height=16):
    """One huge quad filling the whole view + one light: no silhouettes."""
    d = {
        "settings": {
            "background_color": [0, 0, 0],
            "image_settings": {"width": width, "height": height},
        },
        "camera": {
            "matrix": [1, 0, 0, 0, 1, 0, 0, 0, 1],
            "position": [0, 0, 3],
        },
        "materials": [
            {"type": "diffuse", "albedo": [0.7, 0.5, 0.3],
             "smooth_shading": True}
        ],
        "lights": [{"intensity": 800, "position": [1.0, 2.0, 2.0]}],
        "objects": [
            {
                "material_index": 0,
                "vertices": [
                    -50, -50, 0, 50, -50, 0, -50, 50, 0, 50, 50, 0,
                ],
                "triangles": [0, 1, 2, 2, 1, 3],
            }
        ],
    }
    return scene_from_dict(d)


def _fd_check(loss, x0, indices, eps, rtol, name):
    """Central differences with an eps sweep: the f32 renderer's rounding
    noise vs truncation error trades off differently per coordinate, so
    each coordinate may pick its best step (standard f32 gradcheck)."""
    g = jax.grad(loss)(x0)
    g = np.asarray(g)
    assert np.isfinite(g).all(), name
    flat = x0.ravel()
    for idx in indices:
        an = float(g.ravel()[idx])
        errs = []
        for e in (eps, 3 * eps, 10 * eps):
            xp = flat.at[idx].add(e).reshape(x0.shape)
            xm = flat.at[idx].add(-e).reshape(x0.shape)
            fd = (float(loss(xp)) - float(loss(xm))) / (2 * e)
            errs.append((abs(an - fd), fd))
        err, fd = min(errs)
        assert err <= rtol * max(abs(an), abs(fd), 1e-3), (
            f"{name}[{idx}]: analytic={an} best fd={fd}"
        )


@pytest.fixture(scope="module")
def wall():
    return _wall_scene()


def _loss_fn(scene, **replace):
    s = scene.replace(**replace)
    img = render_image(s, RenderSettings(), jit=False)
    # non-uniform weighting so spatially-varying effects register
    w = jnp.cos(jnp.arange(img.size, dtype=jnp.float32)).reshape(img.shape)
    return jnp.sum(img * (1.0 + 0.3 * w))


def test_fd_light_intensity(wall):
    _fd_check(
        lambda x: _loss_fn(wall, light_intensity=x),
        wall.light_intensity, [0], eps=1.0, rtol=1e-2,
        name="light_intensity",
    )


def test_fd_light_position(wall):
    _fd_check(
        lambda x: _loss_fn(wall, light_position=x),
        wall.light_position, [0, 1, 2], eps=1e-3, rtol=1e-2,
        name="light_position",
    )


def test_fd_albedo(wall):
    _fd_check(
        lambda x: _loss_fn(wall, tex_color_a=x),
        wall.tex_color_a, [0, 1, 2], eps=1e-3, rtol=1e-2,
        name="tex_color_a",
    )


def test_fd_vertices(wall):
    # all 4 quad corners, every coordinate
    _fd_check(
        lambda x: _loss_fn(wall, vertices=x),
        wall.vertices, list(range(12)), eps=1e-3, rtol=3e-2,
        name="vertices",
    )


def test_fd_camera_position(wall):
    _fd_check(
        lambda x: _loss_fn(wall, cam_position=x),
        wall.cam_position, [0, 1, 2], eps=1e-4, rtol=3e-2,
        name="cam_position",
    )


def test_fd_camera_rotation(wall):
    _fd_check(
        lambda x: _loss_fn(wall, cam_rotation=x),
        wall.cam_rotation, [0, 4, 8, 1], eps=1e-4, rtol=3e-2,
        name="cam_rotation",
    )


def test_pallas_backend_gradients_match_bruteforce():
    """Differentiate THROUGH the Pallas trace (interpret mode): hit ids are
    identical to bruteforce, so gradients must be too."""
    from crt_tpu.ops.pallas_trace import make_pallas_trace_fn
    from crt_tpu.scene.procedural import make_test_scene

    scene = make_test_scene(width=24, height=16, num_quads=4)
    settings = RenderSettings()
    rx, ry, _ = make_tiler(scene.height, scene.width)

    def loss_with(trace_fn, vertices):
        s = scene.replace(vertices=vertices)
        o, d = camera_ops.generate_rays(
            s.cam_position, s.cam_rotation, s.cam_tan_half_fov,
            s.width, s.height, rx, ry,
        )
        col = shade_wavefront(
            s, settings, trace_fn, o, d,
            rx.astype(jnp.uint32), ry.astype(jnp.uint32),
        )
        return jnp.sum(col ** 2)

    pallas_trace = make_pallas_trace_fn(scene, interpret=True)
    brute_trace = make_trace_fn(
        scene, RenderSettings(backend="bruteforce")
    )

    gp = jax.grad(lambda v: loss_with(pallas_trace, v))(scene.vertices)
    gb = jax.grad(lambda v: loss_with(brute_trace, v))(scene.vertices)
    assert bool(jnp.all(jnp.isfinite(gp)))
    # rtol covers exact-tie pixels where the two backends may legitimately
    # pick a different (equal-distance) triangle
    np.testing.assert_allclose(
        np.asarray(gp), np.asarray(gb), rtol=2e-3, atol=1e-4
    )


def test_remat_shading_gradients_bit_identical():
    """remat_shading=True recomputes the elementwise shading chain in the
    backward (policy remat keeping only trace outputs + packed rows); the
    recompute is the same program, so value AND gradients must be
    bit-identical to the default path."""
    from crt_tpu.renderer import _render_flat
    from crt_tpu.scene.procedural import make_test_scene

    scene = make_test_scene(width=24, height=16, num_quads=4)
    base = RenderSettings(backend="bruteforce")
    remat = RenderSettings(backend="bruteforce", remat_shading=True)

    def loss(v, li, c, settings):
        s = scene.replace(vertices=v, light_intensity=li, cam_position=c)
        return jnp.sum(_render_flat(s, settings))

    args = (scene.vertices, scene.light_intensity, scene.cam_position)
    vb, gb = jax.value_and_grad(
        lambda *a: loss(*a, base), argnums=(0, 1, 2))(*args)
    vr, gr = jax.value_and_grad(
        lambda *a: loss(*a, remat), argnums=(0, 1, 2))(*args)
    assert float(vb) == float(vr)
    for a, b in zip(gb, gr):
        assert bool(jnp.array_equal(a, b))


def test_remat_shading_pallas_rows_path():
    """Same remat-parity demand through the Pallas trace (interpret mode),
    the GPU production path, under jax.checkpoint."""
    from crt_tpu.ops.pallas_trace import make_pallas_trace_fn
    from crt_tpu.scene.procedural import make_test_scene

    scene = make_test_scene(width=24, height=16, num_quads=4)
    base = RenderSettings()
    remat = RenderSettings(remat_shading=True)
    trace_fn = make_pallas_trace_fn(scene, interpret=True)
    rx, ry, _ = make_tiler(scene.height, scene.width)

    def loss(v, settings):
        s = scene.replace(vertices=v)
        o, d = camera_ops.generate_rays(
            s.cam_position, s.cam_rotation, s.cam_tan_half_fov,
            s.width, s.height, rx, ry,
        )
        col = shade_wavefront(
            s, settings, trace_fn, o, d,
            rx.astype(jnp.uint32), ry.astype(jnp.uint32),
        )
        return jnp.sum(col ** 2)

    vb, gb = jax.value_and_grad(lambda v: loss(v, base))(scene.vertices)
    vr, gr = jax.value_and_grad(lambda v: loss(v, remat))(scene.vertices)
    assert float(vb) == float(vr)
    assert bool(jnp.array_equal(gb, gr))
