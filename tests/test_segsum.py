"""Per-triangle gradient accumulation: the packed-row gather
(crt_tpu.ops.gather) whose VJP is XLA's scatter-add (segment sum) into the
[K, T] table.  Checked against the plain gather, finite differences, an
explicit segment-sum reference, and under shard_map."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from crt_tpu.ops import gather as gm


def _segment_sum_reference(tri, g, T):
    out = np.zeros((g.shape[0], T), np.float64)
    for r in range(tri.shape[0]):
        out[:, tri[r]] += g[:, r]
    return out


def test_packed_gather_forward_and_grad():
    rng = np.random.default_rng(3)
    K, T, R = 6, 40, 200
    packed = jnp.asarray(rng.normal(size=(K, T)).astype(np.float32))
    tri = jnp.asarray(rng.integers(0, T, size=R).astype(np.int32))

    out = gm.packed_gather(packed, tri)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(packed[:, tri]))

    def loss(p):
        return jnp.sum(gm.packed_gather(p, tri) ** 2)

    g_custom = jax.grad(loss)(packed)
    g_plain = jax.grad(lambda p: jnp.sum(p[:, tri] ** 2))(packed)
    np.testing.assert_allclose(
        np.asarray(g_custom), np.asarray(g_plain), rtol=1e-5, atol=1e-5
    )


@pytest.mark.parametrize("R,T,dup", [(300, 50, "random"), (64, 8, "all_same"),
                                     (128, 512, "sparse")])
def test_gather_vjp_is_segment_sum(R, T, dup):
    """The VJP accumulates every ray's cotangent into its triangle's column
    (many rays share a triangle: the atomic-add case on the GPU)."""
    rng = np.random.default_rng(R + T)
    K = 5
    if dup == "all_same":
        tri = np.full(R, 3, np.int32)
    else:
        tri = rng.integers(0, T, size=R).astype(np.int32)
    packed = jnp.asarray(rng.normal(size=(K, T)).astype(np.float32))
    g = rng.normal(size=(K, R)).astype(np.float32)
    _, vjp = jax.vjp(lambda p: gm.packed_gather(p, jnp.asarray(tri)), packed)
    (grad,) = vjp(jnp.asarray(g))
    np.testing.assert_allclose(
        np.asarray(grad), _segment_sum_reference(tri, g, T),
        rtol=1e-5, atol=1e-5,
    )


def test_gather_vjp_matches_finite_differences():
    rng = np.random.default_rng(11)
    K, T, R = 4, 12, 90
    packed = jnp.asarray(rng.normal(size=(K, T)), jnp.float64 if
                         jax.config.jax_enable_x64 else jnp.float32)
    tri = jnp.asarray(rng.integers(0, T, size=R).astype(np.int32))
    wts = jnp.asarray(rng.normal(size=(K, R)).astype(np.float32))

    def loss(p):
        return jnp.sum(jnp.sin(gm.packed_gather(p, tri)) * wts)

    g = np.asarray(jax.grad(loss)(packed))
    eps = 1e-2
    for k, t in ((0, 0), (1, 5), (3, 11), (2, int(tri[0]))):
        e = jnp.zeros_like(packed).at[k, t].set(eps)
        fd = (float(loss(packed + e)) - float(loss(packed - e))) / (2 * eps)
        np.testing.assert_allclose(g[k, t], fd, rtol=2e-2, atol=2e-3)


def test_gather_grad_under_shard_map_is_psummed():
    """Under shard_map the replicated table is cast to vary over the rays
    axis; the transpose of the cast sums the per-device partial gradients,
    so the sharded gradient equals the single-device one."""
    from jax.sharding import Mesh, PartitionSpec as P

    n = 4
    mesh = Mesh(np.array(jax.devices()[:n]), ("rays",))
    rng = np.random.default_rng(5)
    K, T, R = 3, 20, 64
    packed = jnp.asarray(rng.normal(size=(K, T)).astype(np.float32))
    tri = jnp.asarray(rng.integers(0, T, size=R).astype(np.int32))

    @functools.partial(jax.shard_map, mesh=mesh, in_specs=(P(), P("rays")),
                       out_specs=P())
    def sharded_grad(p, tri_local):
        def loss(p):
            return jax.lax.psum(
                jnp.sum(gm.packed_gather(p, tri_local) ** 2), "rays"
            )
        return jax.grad(loss)(p)

    g_sharded = jax.jit(sharded_grad)(packed, tri)
    g_single = jax.grad(lambda p: jnp.sum(p[:, tri] ** 2))(packed)
    np.testing.assert_allclose(np.asarray(g_sharded), np.asarray(g_single),
                               rtol=1e-5, atol=1e-5)


def test_render_grad_unchanged_by_custom_vjp():
    """End-to-end: gradients through hit_attributes (which routes the
    gather through packed_gather) match finite differences."""
    from crt_tpu import RenderSettings, render_image
    from crt_tpu.scene.procedural import make_test_scene

    scene = make_test_scene(width=16, height=12, num_quads=3)

    def loss(lights):
        img = render_image(
            scene.replace(light_intensity=lights), RenderSettings(),
            jit=False,
        )
        return jnp.sum(img)

    g = jax.grad(loss)(scene.light_intensity)
    eps = 1e-2
    for i in range(scene.light_intensity.shape[0]):
        li = scene.light_intensity.at[i].add(eps)
        lo = scene.light_intensity.at[i].add(-eps)
        fd = (loss(li) - loss(lo)) / (2 * eps)
        # rtol bounded by f32 cancellation in the FD numerator
        np.testing.assert_allclose(float(g[i]), float(fd), rtol=1e-2)
