"""Batched, stackless-recursion KD-tree traversal in pure JAX.

The reference walks the tree per ray with a heap ``std::stack``
(crt_intersection.cpp:109-136).  Here the whole wavefront traverses in
lock-step inside one ``lax.while_loop``: every ray carries a fixed-size stack
*array* (tree depth is bounded by MAX_ACCELERATION_TREE_DEPTH=39, so 48
slots suffice), and each iteration pops one node per ray, tests its AABB,
intersects the (padded) leaf triangle block, or pushes the two children.

All memory access is gathers over the flat AccelTree SoA — no pointers, no
divergence: inactive rays (empty stack) simply mask out.  This backend is
fully shape-static and differentiable-by-recomputation like the brute-force
one; the Pallas kernel in pallas_trace.py is the faster GPU path.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from crt_tpu.ops import vecmath
from crt_tpu.ops.intersect import PARALLEL_EPS, Hit

STACK_SIZE = 48


class TriangleGather(NamedTuple):
    """Per-triangle constants in gather-friendly layout."""

    n: jnp.ndarray  # [T, 3] face normal
    n_dot_v0: jnp.ndarray  # [T]
    m: jnp.ndarray  # [T, 3, 3] edge normals (n x e_i)
    c: jnp.ndarray  # [T, 3] m_i . v_i
    backface: jnp.ndarray  # [T] bool


def build_triangle_gather(vertices, tri_vidx, tri_backface) -> TriangleGather:
    v0 = vertices[tri_vidx[:, 0]]
    v1 = vertices[tri_vidx[:, 1]]
    v2 = vertices[tri_vidx[:, 2]]
    n = vecmath.safe_normalize(vecmath.cross(v1 - v0, v2 - v0))
    e0, e1, e2 = v1 - v0, v2 - v1, v0 - v2
    m0, m1, m2 = vecmath.cross(n, e0), vecmath.cross(n, e1), vecmath.cross(n, e2)
    c = jnp.stack(
        [vecmath.dot(m0, v0), vecmath.dot(m1, v1), vecmath.dot(m2, v2)], axis=-1
    )
    return TriangleGather(
        n=n,
        n_dot_v0=vecmath.dot(n, v0),
        m=jnp.stack([m0, m1, m2], axis=1),
        c=c,
        backface=jnp.asarray(tri_backface, bool),
    )


def _ray_aabb(o, d, bmin, bmax):
    """Slab test: does the ray segment [0, inf) hit the closed box?

    Geometric equivalent of the reference per-face test
    (crt_intersection.cpp:14-45); inclusive on boundaries.
    """
    inv = 1.0 / jnp.where(jnp.abs(d) > 1e-30, d, jnp.where(d >= 0, 1e-30, -1e-30))
    t1 = (bmin - o) * inv
    t2 = (bmax - o) * inv
    tnear = jnp.max(jnp.minimum(t1, t2), axis=-1)
    tfar = jnp.min(jnp.maximum(t1, t2), axis=-1)
    return tfar >= jnp.maximum(tnear, 0.0)


def _leaf_intersect(tri: TriangleGather, leaf_tri_ids, o, d, best_t, best_tri):
    """Intersect each ray with its [L]-padded leaf triangle block.

    leaf_tri_ids: [R, L] triangle ids (-1 pad).  Faithful plane + three
    half-space test (crt_intersection.cpp:47-93) on gathered constants.
    """
    pad = leaf_tri_ids < 0
    ids = jnp.maximum(leaf_tri_ids, 0)

    n = tri.n[ids]  # [R, L, 3]
    nv0 = tri.n_dot_v0[ids]  # [R, L]
    m = tri.m[ids]  # [R, L, 3, 3]
    c = tri.c[ids]  # [R, L, 3]
    bf = tri.backface[ids]  # [R, L]

    do = d[:, None, :]  # [R, 1, 3]
    oo = o[:, None, :]

    nd = vecmath.dot(n, do)
    opd = nv0 - vecmath.dot(n, oo)
    not_parallel = jnp.abs(nd) >= PARALLEL_EPS
    front = opd < 0.0
    face_ok = front | ~bf
    t = opd / jnp.where(not_parallel, nd, 1.0)

    # HIGHEST: a default-precision f32 einsum may run in TF32 — edge-test
    # cancellation needs full f32 (see vecmath.rotate_rows)
    hi = jax.lax.Precision.HIGHEST
    md = jnp.einsum("rlij,rj->rli", m, d, precision=hi)  # [R, L, 3]
    mo = jnp.einsum("rlij,rj->rli", m, o, precision=hi)
    edge = (mo - c) + t[..., None] * md
    inside = jnp.all(edge >= 0.0, axis=-1)

    valid = not_parallel & face_ok & (t >= 0.0) & inside & ~pad
    t = jnp.where(valid, t, jnp.inf)

    lt = jnp.min(t, axis=1)
    li = jnp.argmin(t, axis=1)
    ltri = jnp.take_along_axis(leaf_tri_ids, li[:, None], axis=1)[:, 0]

    better = lt < best_t
    return (
        jnp.where(better, lt, best_t),
        jnp.where(better, ltri, best_tri),
    )


def closest_hit_tree(accel, tri: TriangleGather, origins, dirs,
                     active=None) -> Hit:
    """Wavefront KD traversal -> Hit for any leading batch shape.

    ``active`` lanes start with the root pushed; inactive lanes start with
    an empty stack and fall out of the lockstep loop immediately.
    """
    batch_shape = origins.shape[:-1]
    o = origins.reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    R = o.shape[0]

    stack0 = jnp.zeros((R, STACK_SIZE), jnp.int32)
    if active is None:
        sp0 = jnp.ones((R,), jnp.int32)  # root pre-pushed
    else:
        sp0 = jnp.asarray(active, bool).reshape(-1).astype(jnp.int32)
    best_t0 = jnp.full((R,), jnp.inf, jnp.float32)
    best_tri0 = jnp.full((R,), -1, jnp.int32)
    rows = jnp.arange(R)

    def cond(state):
        _, sp, _, _ = state
        return jnp.any(sp > 0)

    def body(state):
        stack, sp, best_t, best_tri = state
        active = sp > 0
        top = jnp.maximum(sp - 1, 0)
        node = jnp.where(active, stack[rows, top], 0)
        sp = jnp.where(active, sp - 1, sp)

        bmin = accel.node_min[node]
        bmax = accel.node_max[node]
        hit_box = active & _ray_aabb(o, d, bmin, bmax)

        leaf_id = accel.node_leaf_id[node]
        is_leaf = leaf_id >= 0

        # Leaf: intersect the padded triangle block (masked by hit status).
        leaf_ids = jnp.where(
            (hit_box & is_leaf)[:, None],
            accel.leaf_tris[jnp.maximum(leaf_id, 0)],
            -1,
        )
        best_t, best_tri = _leaf_intersect(tri, leaf_ids, o, d, best_t, best_tri)

        # Internal: push child0 then child1 (pop order matches the
        # reference's std::stack, crt_intersection.cpp:127-130).
        children = accel.node_children[node]  # [R, 2]
        descend = hit_box & ~is_leaf
        for k in (0, 1):
            ck = children[:, k]
            push = descend & (ck >= 0)
            pos = jnp.where(push, sp, 0)
            stack = stack.at[rows, pos].set(
                jnp.where(push, ck, stack[rows, pos])
            )
            sp = sp + push.astype(jnp.int32)

        return stack, sp, best_t, best_tri

    _, _, best_t, best_tri = jax.lax.while_loop(
        cond, body, (stack0, sp0, best_t0, best_tri0)
    )
    return Hit(
        t=best_t.reshape(batch_shape), tri=best_tri.reshape(batch_shape)
    )


def make_tree_trace_fn(scene):
    """trace_fn factory for the tree backend."""
    assert scene.accel is not None, "scene has no acceleration tree"
    tri = build_triangle_gather(
        jax.lax.stop_gradient(scene.vertices),
        scene.tri_vidx,
        scene.mat_backface[scene.tri_material],
    )

    def trace(o, d, active=None):
        return closest_hit_tree(scene.accel, tri, o, d, active)

    return trace
