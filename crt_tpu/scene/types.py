"""Scene data model: frozen SoA pytrees.

The reference keeps a pointer-rich ``crt::Scene`` (reference
``src/core/crt_scene.h:18-30``): vertex vector, triangles holding raw vertex
pointers, a pointer KD-tree, tagged-union textures.  None of that maps to XLA.
Here the whole scene is a *flat struct-of-arrays pytree*: every hot quantity is
a dense ``jnp`` array so the renderer can be traced once and vectorized over
the full ray wavefront, and so gradients flow to vertices / normals / albedo /
lights / camera with no special casing.

Static metadata (resolution, feature flags) lives in pytree *meta* fields so
JIT specializes per scene shape/feature combo — the compiled analog of the
reference's compile-time material switch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

# Material type codes — mirror reference enum order (src/core/crt_material.h:5-10).
MATERIAL_DIFFUSE = 0
MATERIAL_REFLECTIVE = 1
MATERIAL_REFRACTIVE = 2
MATERIAL_CONSTANT = 3

MATERIAL_TYPE_NAMES = ("diffuse", "reflective", "refractive", "constant")

# Texture type codes — mirror reference enum order (src/core/crt_texture.h:8-13).
TEXTURE_ALBEDO = 0
TEXTURE_EDGES = 1
TEXTURE_CHECKER = 2
TEXTURE_BITMAP = 3

TEXTURE_TYPE_NAMES = ("albedo", "edges", "checker", "bitmap")

# Defaults mirroring reference src/core/crt_renderer.h:10-16 and crt_scene.h:16.
DEFAULT_SCENE_BUCKET_SIZE = 24
DEFAULT_MAX_RAY_DEPTH = 3
DEFAULT_DIFFUSE_REFLECTION_RAY_COUNT = 4
DEFAULT_SHADOW_BIAS = 1e-2
DEFAULT_REFLECTION_BIAS = 1e-2
DEFAULT_DIFFUSE_REFLECTION_BIAS = 1e-2
DEFAULT_REFRACTION_BIAS = 1e-2

# Acceleration-tree constants mirroring reference crt_acceleration_tree.h:12-13.
MAX_ACCELERATION_TREE_DEPTH = 39
MAX_BOX_TRIANGLE_COUNT = 16


def _pytree_dataclass(cls=None, *, meta_fields=()):
    """Register a frozen dataclass as a JAX pytree with static meta fields."""

    def wrap(c):
        c = dataclasses.dataclass(frozen=True)(c)
        data_fields = [
            f.name for f in dataclasses.fields(c) if f.name not in meta_fields
        ]
        jax.tree_util.register_dataclass(
            c, data_fields=data_fields, meta_fields=list(meta_fields)
        )
        return c

    if cls is None:
        return wrap
    return wrap(cls)


@_pytree_dataclass(meta_fields=("leaf_size", "num_nodes", "num_leaves"))
class AccelTree:
    """Flattened midpoint-split KD/AABB tree.

    The reference stores ``std::vector<AccelerationTreeNode>`` whose leaves own
    triangle *copies* (crt_acceleration_tree.h:15-24).  Here the tree is four
    dense arrays; leaves index into a padded ``[num_leaves, leaf_size]``
    triangle-id table so a Pallas kernel can stream any leaf with one dynamic
    slice.
    """

    node_min: jnp.ndarray  # [N, 3] f32  AABB lower corner
    node_max: jnp.ndarray  # [N, 3] f32  AABB upper corner
    node_children: jnp.ndarray  # [N, 2] i32, -1 = absent child
    node_leaf_id: jnp.ndarray  # [N] i32 row into leaf_tris, -1 = internal node
    leaf_tris: jnp.ndarray  # [num_leaves, leaf_size] i32 triangle ids, -1 pad
    leaf_node: jnp.ndarray  # [num_leaves] i32 owning node id (for leaf AABBs)
    leaf_size: int = MAX_BOX_TRIANGLE_COUNT
    num_nodes: int = 0
    num_leaves: int = 0


_SCENE_META = (
    "width",
    "height",
    "bucket_size",
    "gi_on",
    "reflections_on",
    "refractions_on",
    "has_reflective",
    "has_refractive",
    "has_constant",
    "has_materials",
    "has_lights",
    "any_smooth",
    "texture_types_present",
)


@_pytree_dataclass(meta_fields=_SCENE_META)
class Scene:
    """Render-ready scene as one SoA pytree.

    Mirrors the content of reference ``crt::Scene`` (crt_scene.h:18-30) plus
    the precomputed per-vertex smooth normals the reference accumulates at mesh
    assembly time (crt_mesh.cpp:10-30).
    """

    # Geometry ---------------------------------------------------------------
    vertices: jnp.ndarray  # [V, 3] f32 world-space positions
    vertex_normals: jnp.ndarray  # [V, 3] f32 accumulated smooth normals
    vertex_uvs: jnp.ndarray  # [V, 3] f32 (reference uv is a 3-vector)
    tri_vidx: jnp.ndarray  # [T, 3] i32 CCW vertex indices
    tri_material: jnp.ndarray  # [T] i32 material index

    # Materials --------------------------------------------------------------
    mat_type: jnp.ndarray  # [M] i32 MATERIAL_* codes
    mat_albedo_tex: jnp.ndarray  # [M] i32 texture index (-1 for refractive)
    mat_ior: jnp.ndarray  # [M] f32 index of refraction
    mat_smooth: jnp.ndarray  # [M] bool smooth_shading flag
    mat_backface: jnp.ndarray  # [M] bool back_face_culling flag

    # Textures ---------------------------------------------------------------
    tex_type: jnp.ndarray  # [X] i32 TEXTURE_* codes
    tex_color_a: jnp.ndarray  # [X, 3] f32 albedo / edge_color / color_A
    tex_color_b: jnp.ndarray  # [X, 3] f32 inner_color / color_B
    tex_scalar: jnp.ndarray  # [X] f32 edge_width / square_size
    tex_bitmap: jnp.ndarray  # [X] i32 row into bitmap_data, -1 = none
    bitmap_data: jnp.ndarray  # [B, Hmax, Wmax, 3] f32 decoded bitmaps
    bitmap_size: jnp.ndarray  # [B, 2] i32 (height, width) of each bitmap

    # Lights -----------------------------------------------------------------
    light_position: jnp.ndarray  # [L, 3] f32
    light_intensity: jnp.ndarray  # [L] f32

    # Camera -----------------------------------------------------------------
    cam_position: jnp.ndarray  # [3] f32
    cam_rotation: jnp.ndarray  # [3, 3] f32 row-major, row-vector convention
    cam_tan_half_fov: jnp.ndarray  # [] f32 tan(fov/2); default fov = 90 deg

    # Misc -------------------------------------------------------------------
    background_color: jnp.ndarray  # [3] f32

    # Acceleration structure (optional; None => brute force) -----------------
    accel: Optional[AccelTree] = None

    # Static metadata (jit-specializing) -------------------------------------
    width: int = 0
    height: int = 0
    bucket_size: int = DEFAULT_SCENE_BUCKET_SIZE
    gi_on: bool = False
    reflections_on: bool = True
    refractions_on: bool = True
    has_reflective: bool = False
    has_refractive: bool = False
    has_constant: bool = False
    has_materials: bool = True
    has_lights: bool = True
    any_smooth: bool = False
    texture_types_present: tuple = ()

    # -- convenience ---------------------------------------------------------
    @property
    def num_triangles(self) -> int:
        return int(self.tri_vidx.shape[0])

    @property
    def num_vertices(self) -> int:
        return int(self.vertices.shape[0])

    @property
    def num_lights(self) -> int:
        return int(self.light_position.shape[0])

    def replace(self, **kw) -> "Scene":
        return dataclasses.replace(self, **kw)


_SETTINGS_FIELDS = (
    "max_ray_depth",
    "diffuse_reflection_ray_count",
    "shadow_bias",
    "reflection_bias",
    "diffuse_reflection_bias",
    "refraction_bias",
    "head_compat",
    "compat_no_shadows",
    "compat_gi_divide",
    "compat_hadamard_y",
    "backend",
    "chunk_pixels",
    "wavefront",
    "wavefront_banks",
    "wavefront_sched",
    "remat_shading",
    "aov",
    "fused_light_vjp",
)


@_pytree_dataclass(meta_fields=_SETTINGS_FIELDS)
class RenderSettings:
    """Mirror of reference ``crt::RendererSettings`` (crt_renderer.h:18-25).

    All fields are static: ``max_ray_depth`` / ``diffuse_reflection_ray_count``
    bound loop unrolling, and the biases are compile-time constants exactly as
    in the reference.

    Compat quirks.  The reference accumulated three behavioral bugs over the
    course (SURVEY.md §3.2), each present in a different subset of the
    committed golden renders:

      - ``compat_no_shadows``: shadow occlusion dead code — every surface lit
        (crt_renderer.cpp:32-33; empirically present in the 13-01/14-01
        goldens, absent in 09-*/11-*/12-* goldens)
      - ``compat_gi_divide``: diffuse color divided by
        ``diffuse_reflection_ray_count + 1`` even with GI off
        (crt_renderer.cpp:98)
      - ``compat_hadamard_y``: the Hadamard operator* typo (albedo.y is
        squared) in reflective shading (crt_vector.h:77)

    ``head_compat=True`` switches all three on, replicating the surveyed
    HEAD exactly.  The default (all off) implements the intended behavior.

    ``backend`` selects the intersection engine:
      - "auto":  "pallas" on the GPU, "bruteforce" on the CPU (see
        renderer.resolve_backend)
      - "bruteforce": batched all-pairs intersection (the plain reference)
      - "tree":  batched lax.while_loop KD traversal
      - "pallas": tile-binned cluster-walk kernel (Pallas, Triton route)
    """

    max_ray_depth: int = DEFAULT_MAX_RAY_DEPTH
    diffuse_reflection_ray_count: int = DEFAULT_DIFFUSE_REFLECTION_RAY_COUNT
    shadow_bias: float = DEFAULT_SHADOW_BIAS
    reflection_bias: float = DEFAULT_REFLECTION_BIAS
    diffuse_reflection_bias: float = DEFAULT_DIFFUSE_REFLECTION_BIAS
    refraction_bias: float = DEFAULT_REFRACTION_BIAS
    head_compat: bool = False
    compat_no_shadows: bool = False
    compat_gi_divide: bool = False
    compat_hadamard_y: bool = False
    backend: str = "auto"
    # Render the wavefront in sequential chunks of ~this many pixels
    # (0 = whole frame at once).  The bucket renderer: bounds peak device memory
    # for deep recursion (GI) the way the reference's bucket queue bounded
    # nothing but cache footprint (crt_renderer.cpp:157-199).
    chunk_pixels: int = 0
    # Shading strategy for branching (refractive / GI) scenes:
    #   "auto":      iterative bank wavefront when the Whitted tree branches
    #                (refractions or GI on), unrolled recursion otherwise
    #   "recursive": always unroll the recursion at trace time (2^depth
    #                programs on refractive scenes — exact reference
    #                summation order)
    #   "iter":      always the depth-bounded bank wavefront (O(depth)
    #                programs; see crt_tpu.ops.shade_iter)
    wavefront: str = "auto"
    # Bank count (wavefront capacity = banks * rays) for the iterative path;
    # 0 = auto (2^min(max_ray_depth,3), +2*(K+1) with GI on).
    wavefront_banks: int = 0
    # Bounce scheduling for the iterative path:
    #   "auto": bank-growth loop (pool grows 1 -> f -> f^2 -> banks across
    #           bounces, terminal bounce skips spawn work) on GI scenes —
    #           GI cost is ~linear in pool banks; the lax.scan otherwise
    #           (one compiled bounce body, best compile time)
    #   "grow"/"scan": force either.  Radiance-identical (same placement,
    #   same drops; see shade_iter bank-growth bound).
    wavefront_sched: str = "auto"
    # Policy-remat the unrolled shading: the backward keeps only trace
    # outputs + packed hit rows as residuals and recomputes the elementwise
    # shading chain (identity for forward-only renders; numerics unchanged).
    remat_shading: bool = False
    # Hand-written VJP for the direct-lighting radiance sum (ops/shade.py
    # light_lum): the backward recomputes the per-light chain analytically
    # from (point, normal) instead of storing the autodiff residuals of the
    # [Ll, R](,3) light tensors.  Forward values are bit-identical (same op
    # order); gradients match autodiff to f32 roundoff
    # (tests/test_fused_light.py).  Off by default: on the previous
    # accelerator the residual-free recompute cost more than the residual
    # memory traffic it saved; not yet measured on the GPU.  The
    # lum-sum-first forward formulation is used either way.
    fused_light_vjp: bool = False
    # Auxiliary output pass instead of the beauty render: "" (beauty),
    # "bary" (the 09-01 course visualization, crt_intersection.cpp:73-74),
    # "normal", "depth", "tri_id", "albedo".  First-class so golden
    # profiles (utils/golden.py) apply verbatim through render_image.
    aov: str = ""

    @property
    def no_shadows(self) -> bool:
        return self.head_compat or self.compat_no_shadows

    @property
    def gi_divide(self) -> bool:
        return self.head_compat or self.compat_gi_divide

    @property
    def hadamard_y(self) -> bool:
        return self.head_compat or self.compat_hadamard_y

    def replace(self, **kw) -> "RenderSettings":
        return dataclasses.replace(self, **kw)
