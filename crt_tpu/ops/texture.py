"""Branchless texture sampling for the wavefront.

The reference's tagged-union ``Texture::sample`` switch (crt_texture.cpp:9-49)
becomes a 4-way ``jnp.select`` over per-ray gathered texture parameters.
All four types are implemented:

  - albedo:  flat color
  - edges:   barycentric edge bands (crt_texture.cpp:14-22): edge color when
             bary_u, bary_v or 1-u-v <= edge_width
  - checker: UV grid parity (crt_texture.cpp:24-36): C-truncated u/size,
             v/size, color_B when (row+col) odd
  - bitmap:  nearest neighbor, V flipped, modulo wrap (crt_texture.cpp:38-45)

Bitmaps of different sizes are packed into one padded [B, Hmax, Wmax, 3]
array with true (h, w) kept per image, so sampling is one gather.

Differentiability: gradients flow to every texture color/parameter and, for
bitmaps, to texel values (nearest-neighbor gather has piecewise-constant
coordinates but linear dependence on texel colors).
"""

from __future__ import annotations

import jax.numpy as jnp

from crt_tpu.scene.types import (
    TEXTURE_ALBEDO,
    TEXTURE_BITMAP,
    TEXTURE_CHECKER,
    TEXTURE_EDGES,
)


def _grad_gather(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Gather rows of a small differentiable table: [X, C][idx] -> [R, C]
    (or [X][idx] -> [R]), shard_map-safe (see crt_tpu.ops.gather)."""
    from crt_tpu.ops.gather import packed_gather

    if idx.ndim != 1:
        return table[idx]
    if table.ndim == 1:
        return packed_gather(table[None, :], idx)[0]
    return packed_gather(table.T, idx).T


def _c_trunc(x: jnp.ndarray) -> jnp.ndarray:
    """float -> int with C++ truncation toward zero (static_cast<int>)."""
    return jnp.trunc(x).astype(jnp.int32)


def _c_mod(a: jnp.ndarray, m: jnp.ndarray) -> jnp.ndarray:
    """C '%' (sign follows dividend), then clipped to [0, m-1] for safety.

    The reference indexes its buffer with the raw C remainder; negative UVs
    would read out of bounds there (UB).  We clamp instead — identical for
    the in-range UVs every course scene uses.
    """
    r = a - jnp.trunc(a / m).astype(jnp.int32) * m
    return jnp.clip(r, 0, m - 1)


def sample_textures(
    scene,
    tex_idx: jnp.ndarray,  # [R] i32 texture index per ray
    uv: jnp.ndarray,  # [R, 3] interpolated uv (reference uv is 3-vector)
    bary_u: jnp.ndarray,  # [R]
    bary_v: jnp.ndarray,  # [R]
) -> jnp.ndarray:
    """Sample per-ray albedo colors -> [R, 3].

    Texture types absent from the scene (static ``texture_types_present``)
    compile to nothing — a flat-albedo scene is a single gather.
    """
    present = set(scene.texture_types_present)
    safe_idx = jnp.maximum(tex_idx, 0)
    ttype = scene.tex_type[safe_idx]  # [R]
    color_a = _grad_gather(scene.tex_color_a, safe_idx)  # [R, 3]
    if present <= {TEXTURE_ALBEDO}:
        return color_a

    color_b = _grad_gather(scene.tex_color_b, safe_idx)  # [R, 3]
    scalar = _grad_gather(scene.tex_scalar, safe_idx)  # [R]
    u, v = uv[..., 0], uv[..., 1]

    conds, choices = [], []

    if TEXTURE_EDGES in present:
        # crt_texture.cpp:14-22
        on_edge = (
            (bary_u <= scalar)
            | (bary_v <= scalar)
            | ((1.0 - bary_u - bary_v) <= scalar)
        )
        edges_color = jnp.where(on_edge[..., None], color_a, color_b)
        conds.append((ttype == TEXTURE_EDGES)[..., None])
        choices.append(edges_color)

    if TEXTURE_CHECKER in present:
        # crt_texture.cpp:24-36
        safe_scalar = jnp.where(scalar != 0.0, scalar, 1.0)
        row = _c_trunc(u / safe_scalar)
        col = _c_trunc(v / safe_scalar)
        odd = ((row + col) & 1).astype(bool)
        checker_color = jnp.where(odd[..., None], color_b, color_a)
        conds.append((ttype == TEXTURE_CHECKER)[..., None])
        choices.append(checker_color)

    if TEXTURE_BITMAP in present and scene.bitmap_data.shape[0] > 0:
        # crt_texture.cpp:38-45
        b = jnp.maximum(scene.tex_bitmap[safe_idx], 0)  # [R]
        h = scene.bitmap_size[b, 0]
        w = scene.bitmap_size[b, 1]
        x = _c_mod(_c_trunc(u * w.astype(jnp.float32)), w)
        y = _c_mod(_c_trunc((1.0 - v) * h.astype(jnp.float32)), h)
        bitmap_color = scene.bitmap_data[b, y, x]
        conds.append((ttype == TEXTURE_BITMAP)[..., None])
        choices.append(bitmap_color)

    if not conds:
        return color_a
    return jnp.select(conds, choices, default=color_a)
