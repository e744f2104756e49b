"""Scene-partitioned rendering on a 2-D (rays x scene) CPU mesh."""

import numpy as np
import jax
import pytest
from jax.sharding import Mesh

from crt_tpu import RenderSettings, render_image
from crt_tpu.parallel.scene_sharded import render_image_scene_sharded
from crt_tpu.scene.procedural import make_test_scene


@pytest.fixture(scope="module")
def mesh2d():
    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    return Mesh(devs, ("rays", "scene"))


def test_scene_sharded_matches_single_device(mesh2d):
    scene = make_test_scene(width=40, height=24, num_quads=7,
                            with_reflective=True)
    single = np.asarray(render_image(scene, RenderSettings(backend="bruteforce")))
    sharded = np.asarray(
        render_image_scene_sharded(scene, RenderSettings(), mesh2d)
    )
    np.testing.assert_allclose(sharded, single, rtol=1e-5, atol=1e-6)


def test_scene_sharded_nondivisible_triangles(mesh2d):
    # 3 quads -> floor(2) + 3 = 5 triangles; 5 % 4 != 0 -> padding path
    scene = make_test_scene(width=16, height=8, num_quads=3,
                            with_reflective=False)
    assert scene.num_triangles % 4 != 0
    single = np.asarray(render_image(scene, RenderSettings(backend="bruteforce")))
    sharded = np.asarray(
        render_image_scene_sharded(scene, RenderSettings(), mesh2d)
    )
    np.testing.assert_allclose(sharded, single, rtol=1e-5, atol=1e-6)


def test_scene_sharded_smooth_materials(mesh2d):
    """Smooth normals widen the packed table (K=18) — exercises the psum
    row exchange across more columns."""
    scene = make_test_scene(width=32, height=16, num_quads=5,
                            with_reflective=True)
    assert scene.any_smooth
    single = np.asarray(render_image(scene, RenderSettings(backend="bruteforce")))
    sharded = np.asarray(
        render_image_scene_sharded(scene, RenderSettings(), mesh2d)
    )
    np.testing.assert_allclose(sharded, single, rtol=1e-5, atol=1e-6)


def test_partitioned_tables_shrink_per_device(mesh2d):
    """THE memory-partitioning criterion: each device holds ~1/N of the
    cluster tables and the packed shading table, not a replica."""
    from crt_tpu.parallel.scene_sharded import build_partitioned_tables

    scene = make_test_scene(width=16, height=8, num_quads=64)
    n_scene = mesh2d.shape["scene"]
    tables, packed, shard_tris = build_partitioned_tables(
        scene, mesh2d, "scene"
    )

    for arr in list(tables) + [packed]:
        total = arr.nbytes
        shard_bytes = {}
        for sh in arr.addressable_shards:
            shard_bytes[sh.device] = sh.data.nbytes
        per_device = max(shard_bytes.values())
        # each device materializes 1/N of the array (x n_ray replication
        # across the rays axis is per-device distinct buffers, still 1/N)
        assert per_device <= total // n_scene, (
            arr.shape, per_device, total
        )
    assert packed.shape[1] == shard_tris * n_scene


def test_refractive_partitioned_matches_single_device(mesh2d):
    """Refractive scenes now run partitioned: the transmissive shadow
    marching's vertex reads route through the rows_fn psum exchange, and
    branching depth picks the iterative bank wavefront on both sides."""
    scene = make_test_scene(width=32, height=16, num_quads=5,
                            with_refractive=True)
    assert scene.has_refractive
    # depth 2 keeps the iterative wavefront selected on the partitioned
    # side (branching refractive) at ~4x less compile than the default 3
    single = np.asarray(
        render_image(scene, RenderSettings(backend="bruteforce",
                                           max_ray_depth=2))
    )
    sharded = np.asarray(
        render_image_scene_sharded(scene, RenderSettings(max_ray_depth=2),
                                   mesh2d)
    )
    np.testing.assert_allclose(sharded, single, rtol=1e-5, atol=1e-5)


def test_scene_sharded_grads_match_single_device(mesh2d):
    """The partitioned-scene TRAINING step: gradients flow back through the
    pmin hit-combine + psum row exchange and match single-device jax.grad
    of the same L2 loss.  Tolerance: rtol 5e-4 / atol 1e-6 — the psum row
    assembly and sharded loss reduction reorder f32 sums vs the
    single-device gather path."""
    import jax
    import jax.numpy as jnp

    from crt_tpu.parallel.scene_sharded import scene_sharded_value_and_grad
    from crt_tpu.parallel.sharded import default_trainable_params

    scene = make_test_scene(width=32, height=16, num_quads=5,
                            with_reflective=True)
    settings = RenderSettings()
    target = jnp.asarray(
        render_image(scene, RenderSettings(backend="bruteforce"))
    ) + 0.03

    params = default_trainable_params(scene)
    loss_sh, grads_sh = scene_sharded_value_and_grad(
        scene, target, params=params, settings=settings, mesh=mesh2d
    )

    h, w = scene.height, scene.width

    def loss_single(p):
        s = scene.replace(**p)
        img = render_image(s, RenderSettings(backend="bruteforce"),
                           jit=False)
        err = img - target
        return jnp.sum(err * err) / (h * w * 3)

    loss_1, grads_1 = jax.value_and_grad(loss_single)(params)

    np.testing.assert_allclose(float(loss_sh), float(loss_1),
                               rtol=1e-5, atol=1e-8)
    for k in params:
        g_sh, g_1 = np.asarray(grads_sh[k]), np.asarray(grads_1[k])
        assert np.isfinite(g_sh).all(), k
        np.testing.assert_allclose(g_sh, g_1, rtol=5e-4, atol=1e-6,
                                   err_msg=k)
    # gradients actually exist (the step isn't silently zero)
    assert max(float(np.abs(np.asarray(grads_sh[k])).max())
               for k in params) > 0


def test_scene_sharded_grads_refractive_iter(mesh2d):
    """Same grad parity through the ITERATIVE bank wavefront on a
    refractive scene — the pool-carry vary_axes path plus the transmissive
    shadow marching's rows_fn reads, differentiated.  rtol 1e-3: the bank
    pool sums root-to-leaf path contributions in a different f32 order
    than the unrolled recursion."""
    import jax
    import jax.numpy as jnp

    from crt_tpu.parallel.scene_sharded import scene_sharded_value_and_grad

    scene = make_test_scene(width=32, height=16, num_quads=5,
                            with_refractive=True)
    settings = RenderSettings(max_ray_depth=2)
    target = jnp.asarray(
        render_image(scene, RenderSettings(backend="bruteforce",
                                           max_ray_depth=2))
    ) + 0.03

    params = {"vertices": scene.vertices,
              "light_intensity": scene.light_intensity}
    loss_sh, grads_sh = scene_sharded_value_and_grad(
        scene, target, params=params, settings=settings, mesh=mesh2d
    )

    h, w = scene.height, scene.width

    def loss_single(p):
        s = scene.replace(**p)
        img = render_image(
            s,
            RenderSettings(backend="bruteforce", max_ray_depth=2,
                           wavefront="iter"),
            jit=False,
        )
        err = img - target
        return jnp.sum(err * err) / (h * w * 3)

    loss_1, grads_1 = jax.value_and_grad(loss_single)(params)
    np.testing.assert_allclose(float(loss_sh), float(loss_1),
                               rtol=1e-4, atol=1e-8)
    for k in params:
        np.testing.assert_allclose(
            np.asarray(grads_sh[k]), np.asarray(grads_1[k]),
            rtol=1e-3, atol=1e-6, err_msg=k,
        )


@pytest.mark.parametrize("platform,expect", [
    ("gpu", "pallas"), ("cpu", "tables"), ("unknown", None),
])
def test_shard_local_backend_choice(platform, expect, monkeypatch):
    """The shard-local ``auto`` backend is the kernel on the GPU, the XLA
    table oracle on the CPU, and an error elsewhere."""
    from crt_tpu.parallel import scene_sharded

    monkeypatch.setattr(scene_sharded.jax, "default_backend",
                        lambda: platform)
    if expect is None:
        with pytest.raises(RuntimeError, match="no default"):
            scene_sharded._resolve_shard_backend("auto")
    else:
        assert scene_sharded._resolve_shard_backend("auto") == expect
    assert scene_sharded._resolve_shard_backend("tables") == "tables"


def test_partitioned_trace_rejects_unknown_backend():
    from crt_tpu.ops.pallas_trace import build_cluster_tables
    from crt_tpu.parallel.scene_sharded import make_partitioned_trace_fn

    scene = make_test_scene(width=8, height=8, num_quads=2)
    with pytest.raises(ValueError, match="shard-local backend"):
        make_partitioned_trace_fn(build_cluster_tables(scene), "scene",
                                  "bruteforce")


def test_scene_sharded_gi_grow_matches_single_device(mesh2d):
    """GI through the partitioned path exercises the bank-GROWTH schedule
    inside shard_map (pool pads must be pcast to the mesh's varying axes):
    radiance must match the single-device render bit-for-bit (same forked
    PCG streams, same placement)."""
    import jax.numpy as jnp  # noqa: F401

    scene = make_test_scene(width=32, height=16, num_quads=5).replace(
        gi_on=True
    )
    single = np.asarray(render_image(
        scene, RenderSettings(backend="bruteforce", max_ray_depth=2)
    ))
    sharded = np.asarray(render_image_scene_sharded(
        scene, RenderSettings(max_ray_depth=2), mesh2d
    ))
    np.testing.assert_array_equal(sharded, single)
