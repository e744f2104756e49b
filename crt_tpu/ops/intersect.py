"""Ray-scene intersection.

The reference intersects one ray against one triangle at a time with an
explicit traversal stack (crt_intersection.cpp:47-93, :109-136).  Here the
same plane + three-half-space test is re-derived so the inner loop becomes a
*matmul*:

For triangle j precompute its face normal ``n_j`` and the three in-plane edge
normals ``m_ij = n_j x e_ij`` (i = 0,1,2).  For a ray (o, d):

    t        = (n_j . v0_j - n_j . o) / (n_j . d)
    test_i   = n_j . (e_ij x (p - v_ij))          # reference edge test
             = (m_ij . o - m_ij . v_ij) + t * (m_ij . d)   # scalar triple id.

so an R-ray x T-triangle intersection needs two [R,3] @ [3,4T] matmuls (for
``d`` and ``o`` against the stacked (n, m0, m1, m2) table) — at
``Precision.HIGHEST``, never TF32 — plus a short elementwise chain and a
masked min-reduction.  No ray ever
branches; validity is a mask:

    valid = |n.d| >= 1e-6  AND  (front_face OR no_backface_culling)
            AND t >= 0  AND  test_0 >= 0 AND test_1 >= 0 AND test_2 >= 0

matching crt_intersection.cpp:52, :58-61, :67-69 bit for bit in semantics.

``closest_hit`` is the non-differentiable index finder (hit distances and
attributes are *recomputed* differentiably from the returned triangle ids by
``crt_tpu.ops.shade.hit_attributes`` — the custom-VJP boundary from
BASELINE.json: gradients flow through intersection attributes, not through
the discrete visibility function).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from crt_tpu.ops import vecmath

PARALLEL_EPS = 1e-6  # crt_intersection.cpp:19, :52


class TriangleData(NamedTuple):
    """Precomputed per-triangle constants for the batched test.

    Built inside jit from scene arrays (cheap: T is small compared to rays);
    all values are stop-gradiented by callers that only need hit *indices*.
    """

    table: jnp.ndarray  # [3, 4T] stacked columns: [n | m0 | m1 | m2]
    n_dot_v0: jnp.ndarray  # [T] n . v0
    c: jnp.ndarray  # [T, 3] m_i . v_i for i = 0,1,2
    backface: jnp.ndarray  # [T] bool back_face_culling per triangle
    num: int  # T


def build_triangle_data(
    vertices: jnp.ndarray,  # [V, 3]
    tri_vidx: jnp.ndarray,  # [T, 3]
    tri_backface: jnp.ndarray,  # [T] bool
) -> TriangleData:
    v0 = vertices[tri_vidx[:, 0]]
    v1 = vertices[tri_vidx[:, 1]]
    v2 = vertices[tri_vidx[:, 2]]

    # Face normal: normalize(edge0 x edge1), edges from v0 (crt_triangle.h:25-33).
    n = vecmath.safe_normalize(vecmath.cross(v1 - v0, v2 - v0))

    # Perimeter edges as used by the inside test (crt_triangle.h:39-45).
    e0 = v1 - v0
    e1 = v2 - v1
    e2 = v0 - v2

    m0 = vecmath.cross(n, e0)
    m1 = vecmath.cross(n, e1)
    m2 = vecmath.cross(n, e2)

    # n.(e_i x (p - v_i)) = (n x e_i).(p - v_i) = m_i.p - m_i.v_i
    c = jnp.stack(
        [vecmath.dot(m0, v0), vecmath.dot(m1, v1), vecmath.dot(m2, v2)],
        axis=-1,
    )  # [T, 3]

    table = jnp.concatenate([n, m0, m1, m2], axis=0).T  # [3, 4T]
    return TriangleData(
        table=table,
        n_dot_v0=vecmath.dot(n, v0),
        c=c,
        backface=jnp.asarray(tri_backface, bool),
        num=int(tri_vidx.shape[0]),
    )


class Hit(NamedTuple):
    t: jnp.ndarray  # [R] f32 distance, +inf on miss
    tri: jnp.ndarray  # [R] i32 triangle id, -1 on miss

    @property
    def valid(self) -> jnp.ndarray:
        return self.tri >= 0


def _intersect_chunk(tri: TriangleData, origins, dirs):
    """All-pairs closest hit for one ray chunk: [Rc,3] x T -> Hit[Rc]."""
    T = tri.num

    dots_d = jax.lax.dot(
        dirs, tri.table, precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )  # [Rc, 4T]
    dots_o = jax.lax.dot(
        origins, tri.table, precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )  # [Rc, 4T]

    nd = dots_d[:, :T]
    od = dots_o[:, :T]  # n . o
    opd = tri.n_dot_v0[None, :] - od  # n . (v0 - o), crt_intersection.cpp:57

    not_parallel = jnp.abs(nd) >= PARALLEL_EPS
    front = opd < 0.0  # crt_intersection.cpp:58
    face_ok = front | ~tri.backface[None, :]

    t = opd / jnp.where(not_parallel, nd, 1.0)

    valid = not_parallel & face_ok & (t >= 0.0)
    for i in range(3):
        md = dots_d[:, (i + 1) * T : (i + 2) * T]
        mo = dots_o[:, (i + 1) * T : (i + 2) * T]
        edge_test = (mo - tri.c[None, :, i]) + t * md
        valid = valid & (edge_test >= 0.0)

    dist = jnp.where(valid, t, jnp.inf)
    best = jnp.min(dist, axis=1)
    idx = jnp.argmin(dist, axis=1).astype(jnp.int32)
    idx = jnp.where(jnp.isfinite(best), idx, -1)
    return Hit(t=best, tri=idx)


def closest_hit_bruteforce(
    tri: TriangleData,
    origins: jnp.ndarray,  # [..., 3]
    dirs: jnp.ndarray,  # [..., 3]
    ray_chunk: int = 8192,
) -> Hit:
    """Closest hit over every triangle, chunked over rays to bound HBM use.

    Works for any leading batch shape; returns Hit with that batch shape.
    """
    batch_shape = origins.shape[:-1]
    o = origins.reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    n = o.shape[0]

    if n <= ray_chunk:
        hit = _intersect_chunk(tri, o, d)
    else:
        pad = (-n) % ray_chunk
        if pad:
            o = jnp.concatenate([o, jnp.zeros((pad, 3), o.dtype)])
            d = jnp.concatenate([d, jnp.zeros((pad, 3), d.dtype)])
        o = o.reshape(-1, ray_chunk, 3)
        d = d.reshape(-1, ray_chunk, 3)
        hit = jax.lax.map(lambda od: _intersect_chunk(tri, od[0], od[1]), (o, d))
        hit = Hit(t=hit.t.reshape(-1)[:n], tri=hit.tri.reshape(-1)[:n])

    return Hit(t=hit.t.reshape(batch_shape), tri=hit.tri.reshape(batch_shape))
