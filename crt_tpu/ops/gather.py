"""Differentiable row gathers of per-triangle tables, shard_map-safe.

The hit-attribute path gathers one packed [K, T] row table at the per-ray
hit-triangle ids (crt_tpu.ops.shade.hit_attributes).  Its VJP is XLA's
scatter-add of the [K, R] cotangents into [K, T], which the GPU runs with
atomic adds.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _vma_of(x) -> frozenset:
    """Varying-manual-axes of ``x`` under shard_map (empty outside)."""
    try:
        return frozenset(getattr(jax.typeof(x), "vma", None) or ())
    except TypeError:  # non-array (e.g. Python int)
        return frozenset()


def _match_varying(x, target_vma: frozenset):
    """Promote ``x`` to vary over every mesh axis in ``target_vma``.

    Inside shard_map the packed scene tables arrive *replicated* (unvarying)
    while the per-ray ids/cotangents vary over the rays mesh axes.  Casting
    the table to varying before the gather makes the per-device partial
    table gradient type-check, and the transpose of the cast is the psum
    that all-reduces the per-device partials — exactly the gradient
    semantics the sharded training step wants (parallel/sharded.py
    inverse_render_step).
    """
    extra = tuple(sorted(target_vma - _vma_of(x)))
    if extra:
        x = jax.lax.pcast(x, extra, to="varying")
    return x


def packed_gather(packed: jnp.ndarray, tri: jnp.ndarray) -> jnp.ndarray:
    """``packed[:, tri]``: packed [K, T], tri [R] i32 (callers pass
    clamped-to-valid ids) -> [K, R]; the VJP is a scatter-add into [K, T]."""
    return _match_varying(packed, _vma_of(tri))[:, tri]
