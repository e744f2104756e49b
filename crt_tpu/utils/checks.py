"""Numerical hygiene checks — the JAX answer to sanitizers.

The reference has no race detection or sanitizers (SURVEY.md §5); its
thread-safety is by construction.  Value-semantics JAX removes data races by
construction too, so the meaningful checks here are numerical:

  - ``check_finite``: render with NaN/Inf detection on every intermediate
    (jax_debug_nans) — catches divides-by-zero or bad normals at their
    source op instead of as black pixels
  - ``check_deterministic``: run a render twice and demand bit-identical
    output (guards against non-deterministic collectives, atomics or
    donation bugs)
  - ``check_grads_finite``: backward-pass NaN scan over all trainable
    parameter groups
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from crt_tpu.renderer import render_image
from crt_tpu.scene.types import RenderSettings, Scene


def check_finite(scene: Scene, settings: RenderSettings | None = None):
    """Render under jax_debug_nans; raises at the producing op on NaN/Inf."""
    settings = settings or RenderSettings()
    with jax.debug_nans(True):
        img = render_image(scene, settings, jit=False)
    img = np.asarray(img)
    assert np.isfinite(img).all(), "non-finite pixels in render"
    return img


def check_deterministic(scene: Scene, settings: RenderSettings | None = None):
    """Two renders must agree bit-for-bit."""
    settings = settings or RenderSettings()
    a = np.asarray(render_image(scene, settings))
    b = np.asarray(render_image(scene, settings))
    if not np.array_equal(a, b):
        diff = np.abs(a - b)
        raise AssertionError(
            f"non-deterministic render: {np.count_nonzero(diff.max(-1))} "
            f"pixels differ, max {diff.max()}"
        )
    return a


def check_grads_finite(scene: Scene, settings: RenderSettings | None = None,
                       params: dict | None = None):
    """Gradients of a sum-loss w.r.t. all trainable groups must be finite."""
    from crt_tpu.parallel.sharded import default_trainable_params

    settings = settings or RenderSettings()
    params = params or default_trainable_params(scene)

    def loss(p):
        return jnp.sum(render_image(scene.replace(**p), settings, jit=False))

    grads = jax.grad(loss)(params)
    bad = [
        name
        for name, g in grads.items()
        if not np.isfinite(np.asarray(g)).all()
    ]
    assert not bad, f"non-finite gradients in {bad}"
    return grads
