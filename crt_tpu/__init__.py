"""crt_tpu — a differentiable ray-tracing framework in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of the
``bvpav/chaos-ray-tracing-course-2025`` CPU renderer:

- ``.crtscene`` JSON scenes -> frozen SoA pytrees (scene/)
- vectorized camera ray generation, wavefront Whitted shading, four material
  and four texture types, point lights with correct shadow occlusion (ops/)
- midpoint-split KD/AABB acceleration tree flattened to SoA arrays, traversed
  either by a batched ``lax.while_loop`` or by a Pallas tile-binning kernel
- end-to-end differentiable: pixel gradients flow to vertices, normals,
  albedo/texture parameters, lights and the camera
- multi-chip scale-out via ``jax.sharding.Mesh`` + ``shard_map`` (parallel/)

The reference's *capabilities* are the spec; its architecture (recursive
shading, pointer KD-tree, thread pools) is deliberately replaced by
wavefront batches, flat arrays and SPMD sharding. See SURVEY.md.
"""

from crt_tpu.scene.types import RenderSettings, Scene, AccelTree
from crt_tpu.scene.json_loader import (
    load_scene,
    scene_from_dict,
    scene_from_json,
)
from crt_tpu.renderer import render_aov, render_image, render_image_hwc
from crt_tpu.progressive import render_progressive

__version__ = "0.1.0"

__all__ = [
    "RenderSettings",
    "Scene",
    "AccelTree",
    "load_scene",
    "scene_from_dict",
    "scene_from_json",
    "render_image",
    "render_image_hwc",
    "render_aov",
    "render_progressive",
]
