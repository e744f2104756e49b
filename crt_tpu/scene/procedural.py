"""Procedural test scenes (no file dependencies).

Used by __graft_entry__, benchmarks and tests when the reference scene files
are unavailable.  Built through the same ``scene_from_dict`` path as real
.crtscene files so they exercise the full loader.
"""

from __future__ import annotations

import numpy as np

from crt_tpu.scene.json_loader import scene_from_dict
from crt_tpu.scene.types import Scene


def make_test_scene(
    width: int = 64,
    height: int = 36,
    num_quads: int = 8,
    seed: int = 0,
    with_reflective: bool = True,
    with_refractive: bool = False,
    with_edges: bool = False,
    gi_on: bool = False,
) -> Scene:
    """A small random quad-soup scene with a floor, lights and materials.

    ``with_edges`` gives the floor a barycentric edge-band texture
    (crt_texture.cpp:14-22) so both texture color tables get sampled —
    used by gradient tests that need nonzero grads on tex_color_b.
    """
    rng = np.random.default_rng(seed)

    objects = [
        {  # floor
            "material_index": 0,
            "vertices": [-20, -2, 20, 20, -2, 20, -20, -2, -20,
                         20, -2, -20],
            "triangles": [0, 1, 2, 3, 2, 1],
        }
    ]
    floor_albedo = "floor_edges" if with_edges else [0.7, 0.7, 0.7]
    mats = [
        {"type": "diffuse", "albedo": floor_albedo, "smooth_shading": False},
        {"type": "diffuse", "albedo": [0.9, 0.2, 0.2], "smooth_shading": True},
    ]
    if with_reflective:
        mats.append(
            {"type": "reflective", "albedo": [0.8, 0.8, 0.9],
             "smooth_shading": False}
        )
    if with_refractive:
        mats.append(
            {"type": "refractive", "ior": 1.5, "smooth_shading": True}
        )

    for i in range(num_quads):
        c = rng.uniform(-6, 6, 3)
        c[1] = rng.uniform(-1.5, 3.0)
        c[2] = -abs(c[2]) - 3.0
        s = rng.uniform(0.4, 1.2)
        v = np.array(
            [c + [-s, -s, 0], c + [s, -s, 0], c + [0, s, 0]], np.float32
        )
        objects.append(
            {
                "material_index": int(rng.integers(1, len(mats))),
                "vertices": v.reshape(-1).tolist(),
                "triangles": [0, 1, 2],
            }
        )

    data = {
        "settings": {
            "background_color": [0.1, 0.2, 0.3],
            "image_settings": {"width": width, "height": height},
            "gi_on": gi_on,
        },
        "camera": {
            "matrix": [1, 0, 0, 0, 1, 0, 0, 0, 1],
            "position": [0, 0, 6],
        },
        "lights": [
            {"intensity": 800, "position": [3, 6, 2]},
            {"intensity": 300, "position": [-4, 5, -1]},
        ],
        "materials": mats,
        "objects": objects,
    }
    if with_edges:
        data["textures"] = [
            {
                "name": "floor_edges",
                "type": "edges",
                "edge_color": [0.2, 0.8, 0.3],
                "inner_color": [0.7, 0.7, 0.7],
                "edge_width": 0.3,
            }
        ]
    return scene_from_dict(data)


def course_benchmark_dict(
    width: int = 1920,
    height: int = 1080,
    seed: int = 0,
) -> dict:
    """Scene dict with the shape of the upstream course's benchmark frame.

    The course's optimisation report times one scene (BASELINE.md): 4,014
    triangles in 2 objects, 4 point lights, 1 diffuse material,
    1920x1080.  Its file is not part of this repository, so this builds a
    stand-in of the same shape from ``seed``: a 2-triangle floor plus a
    closed, seeded, radially displaced torus of 34 x 59 quads (4,012
    triangles), smooth-shaded, lit by 4 point lights, shadows on.
    """
    rng = np.random.default_rng(seed)
    n_u, n_v = 59, 34  # around the ring, around the tube
    u = 2.0 * np.pi * np.arange(n_u) / n_u
    v = 2.0 * np.pi * np.arange(n_v) / n_v
    uu, vv = np.meshgrid(u, v, indexing="ij")  # [n_u, n_v]
    # smooth seeded bumps: a few random low-order harmonics on the tube
    r_tube = np.full(uu.shape, 1.0)
    for _ in range(4):
        ku, kv = rng.integers(1, 6), rng.integers(1, 4)
        ph_u, ph_v = rng.uniform(0, 2 * np.pi, 2)
        r_tube += 0.08 * np.sin(ku * uu + ph_u) * np.cos(kv * vv + ph_v)
    ring = 2.6 + r_tube * np.cos(vv)
    pts = np.stack(
        [ring * np.cos(uu), r_tube * np.sin(vv), ring * np.sin(uu)], -1
    )
    tilt = np.radians(35.0)  # lean the ring toward the camera
    rot = np.array([[1, 0, 0],
                    [0, np.cos(tilt), -np.sin(tilt)],
                    [0, np.sin(tilt), np.cos(tilt)]])
    pts = pts @ rot.T + np.array([0.0, 0.3, -7.0])
    verts = pts.reshape(-1, 3).astype(np.float32)

    iu, iv = np.meshgrid(np.arange(n_u), np.arange(n_v), indexing="ij")
    a = iu * n_v + iv
    b = ((iu + 1) % n_u) * n_v + iv
    c = ((iu + 1) % n_u) * n_v + (iv + 1) % n_v
    d = iu * n_v + (iv + 1) % n_v
    tris = np.stack([np.stack([a, c, b], -1), np.stack([a, d, c], -1)], 2)
    tris = tris.reshape(-1, 3).astype(np.int64)  # 2 * n_u * n_v = 4,012

    return {
        "settings": {
            "background_color": [0.0, 0.5, 0.0],
            "image_settings": {"width": width, "height": height},
        },
        "camera": {
            "matrix": [1, 0, 0, 0, 1, 0, 0, 0, 1],
            "position": [0, 0.5, 0],
        },
        "lights": [
            {"intensity": 900, "position": [-5.0, 8.0, -2.0]},
            {"intensity": 700, "position": [6.0, 7.0, -4.0]},
            {"intensity": 500, "position": [0.0, 9.0, -12.0]},
            {"intensity": 400, "position": [2.0, 3.0, 1.0]},
        ],
        "materials": [
            {"type": "diffuse", "albedo": [0.8, 0.75, 0.7],
             "smooth_shading": True},
        ],
        "objects": [
            {  # floor
                "material_index": 0,
                "vertices": [-40, -3, 20, 40, -3, 20, -40, -3, -60,
                             40, -3, -60],
                "triangles": [0, 1, 2, 3, 2, 1],
            },
            {
                "material_index": 0,
                "vertices": verts.reshape(-1).tolist(),
                "triangles": tris.reshape(-1).tolist(),
            },
        ],
    }


def make_course_benchmark_scene(
    width: int = 1920,
    height: int = 1080,
    seed: int = 0,
) -> Scene:
    """The course-benchmark-shaped frame (see course_benchmark_dict)."""
    return scene_from_dict(course_benchmark_dict(width, height, seed))


def make_big_scene(
    num_triangles: int = 1_000_000,
    width: int = 1920,
    height: int = 1080,
    seed: int = 0,
    build_accel: bool = True,
) -> Scene:
    """A large random-triangle-soup scene built directly as SoA arrays.

    For large-scene benchmarks (S4 in chip_smoke.py): the dict/JSON
    loader path is too slow at 10^6 triangles, so geometry is
    generated vectorized and the Scene pytree assembled directly; the
    acceleration tree uses the native C++ builder.
    """
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    T = num_triangles
    # triangle soup inside a slab in front of the camera
    centers = np.empty((T, 3), np.float32)
    centers[:, 0] = rng.uniform(-30, 30, T)
    centers[:, 1] = rng.uniform(-18, 18, T)
    centers[:, 2] = rng.uniform(-60, -5, T)
    size = rng.uniform(0.02, 0.12, (T, 1)).astype(np.float32)
    offs = rng.standard_normal((T, 3, 3)).astype(np.float32)
    verts = (centers[:, None, :] + offs * size[:, None, :]).reshape(-1, 3)
    tri_vidx = np.arange(3 * T, dtype=np.int32).reshape(T, 3)

    vertex_normals = np.zeros_like(verts)
    vertex_uvs = np.zeros_like(verts)

    scene = Scene(
        vertices=jnp.asarray(verts),
        vertex_normals=jnp.asarray(vertex_normals),
        vertex_uvs=jnp.asarray(vertex_uvs),
        tri_vidx=jnp.asarray(tri_vidx),
        tri_material=jnp.zeros((T,), jnp.int32),
        mat_type=jnp.zeros((1,), jnp.int32),  # diffuse
        mat_albedo_tex=jnp.zeros((1,), jnp.int32),
        mat_ior=jnp.ones((1,), jnp.float32),
        mat_smooth=jnp.zeros((1,), bool),
        mat_backface=jnp.zeros((1,), bool),
        tex_type=jnp.zeros((1,), jnp.int32),
        tex_color_a=jnp.asarray([[0.7, 0.6, 0.5]], jnp.float32),
        tex_color_b=jnp.zeros((1, 3), jnp.float32),
        tex_scalar=jnp.zeros((1,), jnp.float32),
        tex_bitmap=jnp.full((1,), -1, jnp.int32),
        bitmap_data=jnp.zeros((0, 1, 1, 3), jnp.float32),
        bitmap_size=jnp.zeros((0, 2), jnp.int32),
        light_position=jnp.asarray([[0.0, 30.0, 0.0]], jnp.float32),
        light_intensity=jnp.asarray([20000.0], jnp.float32),
        cam_position=jnp.zeros((3,), jnp.float32),
        cam_rotation=jnp.eye(3, dtype=jnp.float32),
        cam_tan_half_fov=jnp.float32(1.0),
        background_color=jnp.asarray([0.05, 0.08, 0.12], jnp.float32),
        accel=None,
        width=width,
        height=height,
        has_reflective=False,
        has_refractive=False,
        has_constant=False,
        any_smooth=False,
        texture_types_present=(0,),
    )
    if build_accel:
        from crt_tpu.scene.accel import build_accel_tree

        scene = scene.replace(accel=build_accel_tree(verts, tri_vidx))
    return scene
