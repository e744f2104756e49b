"""Guard: no default-precision dot may enter the render graph.

On the GPU a float32 matmul at Precision.DEFAULT may run in TF32 (about
three decimal digits) — a single [R,3] @ [3,3] camera rotation at reduced
precision put ~4e-3 relative error on every ray direction and cost ~1.5%
of golden pixels on an earlier accelerator (round 2 discovery).
This test walks the jaxpr of a full render (with every statically-prunable
feature enabled) and fails if any dot_general carries DEFAULT precision,
so the bug class cannot silently return.
"""

import jax
import jax.extend
import jax.numpy as jnp

from crt_tpu import RenderSettings
from crt_tpu.renderer import _render_flat
from crt_tpu.scene.procedural import make_test_scene


def _collect_dots(jaxpr, out):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params.get("precision"))
        for v in eqn.params.values():
            if isinstance(v, jax.extend.core.ClosedJaxpr):
                _collect_dots(v.jaxpr, out)
            elif isinstance(v, jax.extend.core.Jaxpr):
                _collect_dots(v, out)
            elif isinstance(v, (tuple, list)):
                for x in v:
                    if isinstance(x, jax.extend.core.ClosedJaxpr):
                        _collect_dots(x.jaxpr, out)
                    elif isinstance(x, jax.extend.core.Jaxpr):
                        _collect_dots(x, out)
    return out


def _assert_no_default_dots(fn, *args):
    jaxpr = jax.make_jaxpr(fn)(*args)
    precisions = _collect_dots(jaxpr.jaxpr, [])
    bad = [p for p in precisions if p is None or p == jax.lax.Precision.DEFAULT
           or (isinstance(p, tuple)
               and any(x == jax.lax.Precision.DEFAULT for x in p))]
    assert not bad, (
        f"{len(bad)} of {len(precisions)} dot_general ops use DEFAULT "
        "precision — on the GPU that may be a TF32 pass inside the render "
        "graph (see tests/test_precision_guard.py docstring)"
    )


def test_render_graph_has_no_default_precision_dots():
    scene = make_test_scene(
        width=32, height=32, num_quads=6,
        with_reflective=True, with_refractive=True,
    )
    _assert_no_default_dots(
        lambda s: _render_flat(s, RenderSettings(backend="bruteforce")),
        scene,
    )


def test_gi_iter_graph_has_no_default_precision_dots():
    scene = make_test_scene(width=32, height=16, num_quads=3, gi_on=True)
    _assert_no_default_dots(
        lambda s: _render_flat(
            s,
            RenderSettings(
                backend="bruteforce", wavefront="iter",
                diffuse_reflection_ray_count=2, max_ray_depth=2,
            ),
        ),
        scene,
    )


def test_grad_graph_has_no_default_precision_dots():
    scene = make_test_scene(width=24, height=16, num_quads=3)

    def loss(v):
        s = scene.replace(vertices=v)
        return jnp.sum(_render_flat(s, RenderSettings(backend="bruteforce")))

    _assert_no_default_dots(jax.grad(loss), scene.vertices)


def test_sharded_graph_has_no_default_precision_dots():
    """Same guard over the rays-DP shard_map path (parallel/sharded.py)."""
    from crt_tpu.parallel.sharded import make_mesh, render_image_sharded

    scene = make_test_scene(width=32, height=16, num_quads=3,
                            with_reflective=True)
    mesh = make_mesh()
    _assert_no_default_dots(
        lambda s: render_image_sharded(
            s, RenderSettings(backend="bruteforce"), mesh=mesh
        ),
        scene,
    )


def test_scene_sharded_graph_has_no_default_precision_dots():
    """Same guard over the partitioned-scene path (scene_sharded.py)."""
    from crt_tpu.parallel.scene_sharded import render_image_scene_sharded

    scene = make_test_scene(width=32, height=16, num_quads=4)
    _assert_no_default_dots(
        lambda s: render_image_scene_sharded(
            s, RenderSettings(max_ray_depth=1)
        ),
        scene,
    )


def test_grad_sharded_graph_has_no_default_precision_dots():
    """inverse_render_step (psum'd gradient all-reduce) stays exact too."""
    from crt_tpu.parallel.sharded import (
        default_trainable_params, inverse_render_step, make_mesh,
    )

    scene = make_test_scene(width=32, height=16, num_quads=3)
    mesh = make_mesh()
    params = default_trainable_params(scene)
    _assert_no_default_dots(
        lambda target: inverse_render_step(
            scene, target, params,
            settings=RenderSettings(backend="bruteforce"), mesh=mesh,
        )[1],
        jnp.zeros((16, 32, 3), jnp.float32),
    )
