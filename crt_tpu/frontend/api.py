"""Python API mirroring the reference CPython module ``_crt``.

The reference exposes (py_crt_module.cpp:135-169):
  - ``render_scene_from_dict(scene_dict, asset_root, settings)`` returning a
    flat list of (r, g, b, 1.0) tuples with rows flipped vertically for
    Blender (py_crt_module.cpp:102-118)
  - a ``RendererSettings`` 6-tuple type
  - default constants (DEFAULT_SCENE_BUCKET_SIZE, ...)

This module provides the same names and contracts on top of the JAX
renderer so the Blender add-on layer can swap backends with an import
change.  ``render_scene_from_dict_array`` is the efficient array variant
(float32 [H, W, 4], V-flipped).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np

from crt_tpu.renderer import render_image_hwc
from crt_tpu.scene.json_loader import scene_from_dict
from crt_tpu.scene.types import (
    DEFAULT_DIFFUSE_REFLECTION_BIAS,
    DEFAULT_DIFFUSE_REFLECTION_RAY_COUNT,
    DEFAULT_MAX_RAY_DEPTH,
    DEFAULT_REFLECTION_BIAS,
    DEFAULT_REFRACTION_BIAS,
    DEFAULT_SCENE_BUCKET_SIZE,
    DEFAULT_SHADOW_BIAS,
)
from crt_tpu.scene.types import RenderSettings as _RenderSettings


class RendererSettings(NamedTuple):
    """Positional 6-tuple mirroring _crt.RendererSettings
    (py_crt_module.cpp:16-33)."""

    max_ray_depth: int = DEFAULT_MAX_RAY_DEPTH
    diffuse_reflection_ray_count: int = DEFAULT_DIFFUSE_REFLECTION_RAY_COUNT
    shadow_bias: float = DEFAULT_SHADOW_BIAS
    reflection_bias: float = DEFAULT_REFLECTION_BIAS
    diffuse_reflection_bias: float = DEFAULT_DIFFUSE_REFLECTION_BIAS
    refraction_bias: float = DEFAULT_REFRACTION_BIAS


def _to_settings(rs) -> _RenderSettings:
    if isinstance(rs, _RenderSettings):
        return rs
    vals = tuple(rs)
    return _RenderSettings(
        max_ray_depth=int(vals[0]),
        diffuse_reflection_ray_count=int(vals[1]),
        shadow_bias=float(vals[2]),
        reflection_bias=float(vals[3]),
        diffuse_reflection_bias=float(vals[4]),
        refraction_bias=float(vals[5]),
    )


def render_scene_from_dict_array(
    scene_dict: dict,
    asset_root: str = "/",
    renderer_settings: RendererSettings | Sequence | None = None,
) -> np.ndarray:
    """Render a scene dict -> float32 [H, W, 4] RGBA, rows flipped
    vertically (the Blender Combined-pass convention,
    py_crt_module.cpp:102-118)."""
    settings = _to_settings(renderer_settings or RendererSettings())
    scene = scene_from_dict(scene_dict, asset_root=asset_root, strict=True)
    img = np.asarray(render_image_hwc(scene, settings), np.float32)
    rgba = np.concatenate([img, np.ones_like(img[..., :1])], axis=-1)
    return rgba[::-1]  # V-flip


def render_scene_from_dict(
    scene_dict: dict,
    asset_root: str = "/",
    renderer_settings: RendererSettings | Sequence | None = None,
) -> list:
    """Exact _crt contract: flat list of (r, g, b, 1.0) tuples, V-flipped."""
    rgba = render_scene_from_dict_array(scene_dict, asset_root, renderer_settings)
    flat = rgba.reshape(-1, 4)
    return [tuple(px) for px in flat.tolist()]
