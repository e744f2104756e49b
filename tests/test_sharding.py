"""Multi-device sharding tests on the virtual 8-device CPU mesh."""


import numpy as np
import jax
import jax.numpy as jnp
import pytest

from crt_tpu import RenderSettings, render_image
from crt_tpu.parallel.sharded import (
    default_trainable_params,
    inverse_render_step,
    make_mesh,
    render_image_sharded,
    sharded_value_and_grad,
)
from crt_tpu.scene.procedural import make_test_scene


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    return make_mesh(jax.devices()[:8])


@pytest.fixture(scope="module")
def scene():
    return make_test_scene(width=40, height=32, num_quads=5)


def test_sharded_render_matches_single_device(mesh, scene):
    single = np.asarray(render_image(scene, RenderSettings()))
    sharded = np.asarray(render_image_sharded(scene, RenderSettings(), mesh))
    np.testing.assert_allclose(sharded, single, rtol=1e-5, atol=1e-6)


def test_sharded_render_nondivisible_rows(mesh):
    scene = make_test_scene(width=16, height=30, num_quads=3)  # 30 % 8 != 0
    single = np.asarray(render_image(scene, RenderSettings()))
    sharded = np.asarray(render_image_sharded(scene, RenderSettings(), mesh))
    assert sharded.shape == single.shape
    np.testing.assert_allclose(sharded, single, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("light_vjp", ["autodiff", "fused"])
def test_full_param_grads_match_single_device(mesh, scene, light_vjp):
    """Regression gate for the round-2 multichip breakage: train the FULL
    default_trainable_params pytree (vertices + texture tables + lights +
    camera) on the 8-device mesh under both direct-light VJPs and demand
    gradient parity with single-device jax.grad.  Catches (a) custom-VJP
    rules whose cotangent varying-axes don't type-check under shard_map
    and (b) any double/missing cross-device reduction (e.g. an extra psum
    silently scaling grads by mesh size)."""
    del scene  # needs the edges texture so tex_color_b gets nonzero grads
    scene = make_test_scene(width=40, height=32, num_quads=5, with_edges=True)
    settings = RenderSettings(fused_light_vjp=light_vjp == "fused")
    h, w = scene.height, scene.width
    target = render_image(scene, settings) + 0.05
    params = default_trainable_params(scene)

    loss_m, grads_m = sharded_value_and_grad(
        scene, target, params, settings, mesh
    )

    def loss_fn(p):
        img = render_image(scene.replace(**p), settings, jit=False)
        err = img - target
        return jnp.sum(err * err) / (h * w * 3)

    loss_s, grads_s = jax.value_and_grad(loss_fn)(params)

    np.testing.assert_allclose(float(loss_m), float(loss_s), rtol=1e-4)
    for key in params:
        np.testing.assert_allclose(
            np.asarray(grads_m[key]),
            np.asarray(grads_s[key]),
            rtol=1e-4,
            atol=1e-6,
            err_msg=f"grad mismatch for {key} ({light_vjp} light VJP)",
        )
        assert np.abs(np.asarray(grads_s[key])).max() > 0, (
            f"degenerate test: zero reference grad for {key}"
        )


def test_inverse_render_step_reduces_loss(mesh, scene):
    settings = RenderSettings()
    target = render_image_sharded(scene, settings, mesh)

    # perturb vertices, then take gradient steps back toward the target
    rng = np.random.default_rng(1)
    noisy = scene.vertices + jnp.asarray(
        rng.normal(scale=0.05, size=scene.vertices.shape).astype(np.float32)
    )
    params = {"vertices": noisy}

    losses = []
    for _ in range(3):
        params, loss = inverse_render_step(
            scene.replace(vertices=params["vertices"]),
            target,
            params={"vertices": params["vertices"]},
            settings=settings,
            mesh=mesh,
            lr=2e-2,
        )
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses
    assert np.isfinite(losses).all()
