"""Multi-chip scale-out: rays sharded over a device mesh.

The reference's only parallelism is a bucket queue feeding OS threads
(crt_renderer.cpp:157-199).  The JAX equivalent: the pixel wavefront
is sharded across a ``jax.sharding.Mesh`` with ``shard_map`` — each device
renders a contiguous block of pixel rows against a *replicated* scene (course
scenes are <= 4k triangles: replication is free), and scene-*parameter*
gradients are ``psum``-reduced across the mesh, overlapped with the backward
pass by XLA.

Two entry points:
  - ``render_image_sharded``: forward render, rows split over every mesh axis
  - ``inverse_render_step``: one differentiable optimization step against a
    target image (the "training step" of this framework) with the loss and
    parameter gradients all-reduced over the mesh
"""

from __future__ import annotations

import functools
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from crt_tpu.ops import camera as camera_ops
from crt_tpu.ops.shade import shade_wavefront
from crt_tpu.renderer import make_trace_fn
from crt_tpu.scene.types import RenderSettings, Scene


def make_mesh(devices=None, axis_name: str = "rays") -> Mesh:
    """1-D mesh over all available devices (rays axis)."""
    if devices is None:
        devices = jax.devices()
    import numpy as np

    return Mesh(np.array(devices), (axis_name,))


def _render_rows(scene: Scene, settings: RenderSettings, row_start, num_rows: int):
    """Render ``num_rows`` image rows beginning at traced ``row_start``.

    Rays are ordered in the same TILE_H x TILE_W pixel blocks as the
    single-chip renderer so the Pallas binning sees coherent tiles on every
    shard.
    """
    from crt_tpu.renderer import make_tiler

    w = scene.width
    rx, ry, untile = make_tiler(num_rows, w, row_offset=row_start)
    origins, dirs = camera_ops.generate_rays(
        scene.cam_position,
        scene.cam_rotation,
        scene.cam_tan_half_fov,
        scene.width,
        scene.height,
        rx,
        ry,
    )
    trace_fn = make_trace_fn(scene, settings)
    color = shade_wavefront(
        scene,
        settings,
        trace_fn,
        origins.reshape(-1, 3),
        dirs.reshape(-1, 3),
        rx.astype(jnp.uint32),
        ry.astype(jnp.uint32),
    )
    return untile(color)


def render_image_sharded(
    scene: Scene,
    settings: RenderSettings | None = None,
    mesh: Mesh | None = None,
) -> jnp.ndarray:
    """Forward render with pixel rows sharded over every mesh device.

    The scene pytree is replicated; each device generates and shades its own
    row block (no ray data ever crosses ICI — only the final framebuffer
    gather, which jax assembles from the sharded output).
    """
    settings = settings or RenderSettings()
    mesh = mesh or make_mesh()
    n_dev = mesh.size
    axis = mesh.axis_names[0]

    h = scene.height
    rows_per_dev = -(-h // n_dev)  # ceil
    h_pad = rows_per_dev * n_dev

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(axis)),
        out_specs=P(axis),
    )
    def _shard(scene_rep, row_starts):
        return _render_rows(scene_rep, settings, row_starts[0], rows_per_dev)

    row_starts = jnp.arange(0, h_pad, rows_per_dev, dtype=jnp.int32)
    img = jax.jit(_shard)(scene, row_starts)
    return img[:h]


def default_trainable_params(scene: Scene) -> dict:
    """The differentiable scene-parameter pytree used by inverse rendering."""
    return {
        "vertices": scene.vertices,
        "tex_color_a": scene.tex_color_a,
        "tex_color_b": scene.tex_color_b,
        "light_intensity": scene.light_intensity,
        "cam_position": scene.cam_position,
    }


def sharded_value_and_grad(
    scene: Scene,
    target: jnp.ndarray,  # [H, W, 3]
    params: dict | None = None,
    settings: RenderSettings | None = None,
    mesh: Mesh | None = None,
):
    """Sharded L2 loss + scene-parameter gradients over the mesh.

    Forward renders row-sharded, computes an L2 loss, and backpropagates
    through shading + intersection attributes.  Per-device partial gradients
    of the replicated parameters are all-reduced across the mesh (the
    reduction is inserted by AD's transpose of the replicated->varying
    casts, so XLA overlaps it with the remaining backward computation).

    Returns (loss, grads) — both replicated; grads match the single-device
    ``jax.grad`` of the same loss (tests/test_sharding.py parity).
    """
    settings = settings or RenderSettings()
    mesh = mesh or make_mesh()
    n_dev = mesh.size
    axis = mesh.axis_names[0]
    params = params if params is not None else default_trainable_params(scene)

    h, w = scene.height, scene.width
    rows_per_dev = -(-h // n_dev)
    h_pad = rows_per_dev * n_dev
    if h_pad != h:
        pad = jnp.zeros((h_pad - h, w, 3), target.dtype)
        target = jnp.concatenate([target, pad], axis=0)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis)),
        out_specs=(P(), P()),
    )
    def _step(scene_rep, p, target_rows, row_starts):
        def loss_fn(p):
            s = scene_rep.replace(**p)
            img = _render_rows(s, settings, row_starts[0], rows_per_dev)
            # masked rows (padding) contribute zero
            valid = (row_starts[0] + jnp.arange(rows_per_dev)) < h
            err = jnp.where(valid[:, None, None], img - target_rows, 0.0)
            return jnp.sum(err * err) / (h * w * 3)

        loss, grads = jax.value_and_grad(loss_fn)(p)
        loss = jax.lax.psum(loss, axis)
        # grads need NO explicit psum: ``p`` is replicated (unvarying) in
        # the manual region, so AD's transpose of every replicated->varying
        # cast already all-reduces the per-device partials (psum_invariant)
        # and hands back unvarying (replicated) gradients.  An extra
        # psum here would multiply them by mesh size (psum of an unvarying
        # value is N*x) — caught by test_sharding grad-parity vs 1 device.
        return loss, grads

    row_starts = jnp.arange(0, h_pad, rows_per_dev, dtype=jnp.int32)
    return jax.jit(_step)(scene, params, target, row_starts)


def inverse_render_step(
    scene: Scene,
    target: jnp.ndarray,  # [H, W, 3]
    params: dict | None = None,
    settings: RenderSettings | None = None,
    mesh: Mesh | None = None,
    lr: float = 1e-2,
):
    """One sharded SGD step on scene parameters toward a target image
    (see sharded_value_and_grad).  Returns (new_params, loss)."""
    params = params if params is not None else default_trainable_params(scene)
    loss, grads = sharded_value_and_grad(scene, target, params, settings, mesh)
    new_params = jax.tree.map(lambda x, g: x - lr * g, params, grads)
    return new_params, loss
