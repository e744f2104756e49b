"""Batched 3-vector math.

The reference's scalar ``crt::Vector`` / ``crt::Matrix`` (crt_vector.h,
crt_matrix.h) become ``[..., 3]`` array helpers.  Everything is shape-agnostic
over leading batch dims so the same code serves one ray or a 2M-ray wavefront.

Conventions carried over from the reference:
  - matrices are row-major 3x3 applied to ROW vectors: ``v' = v @ M``
    (crt_matrix.h:66-74);
  - ``reflect(v, n) = v - 2 (v.n) n``  (crt_vector.h:119-127);
  - ``refract`` implements Snell with total-internal-reflection rejection
    exactly as crt_vector.cpp:11-27 (including its sin/cos formulation).

The reference's Hadamard ``operator*`` has a typo (``y * rhs.y * y``,
crt_vector.h:77) used only in reflective shading; we implement the correct
product and gate the quirk behind ``head_compat`` at the call site.
"""

from __future__ import annotations

import jax.numpy as jnp


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product over the trailing axis -> [...]."""
    return jnp.sum(a * b, axis=-1)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched 3D cross product (crt_vector.h:104-110)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-1
    )


def length_squared(v: jnp.ndarray) -> jnp.ndarray:
    return dot(v, v)


def length(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(length_squared(v))


def safe_length(v: jnp.ndarray, eps: float = 1e-30) -> jnp.ndarray:
    """|v| with a finite gradient at v = 0.

    d sqrt(x)/dx blows up at x = 0, so ``length`` NaN-poisons the backward
    pass wherever a wavefront lane's cross product is exactly zero (e.g. a
    pixel ray hitting exactly on a triangle edge makes the barycentric
    numerator vanish).  Clamping the radicand changes the forward value by
    at most sqrt(eps) = 1e-15 and zeroes the (mathematically undefined)
    gradient at the origin.
    """
    return jnp.sqrt(jnp.maximum(length_squared(v), eps))


def normalize(v: jnp.ndarray) -> jnp.ndarray:
    """v / |v| — matches reference normalize() (no epsilon; crt_vector.h:97)."""
    return v / length(v)[..., None]


def safe_normalize(v: jnp.ndarray, eps: float = 1e-20) -> jnp.ndarray:
    """Normalize that returns 0 for (near-)zero vectors instead of NaN.

    Used on masked-out wavefront lanes where the reference would simply never
    execute the code path.
    """
    n2 = length_squared(v)
    inv = jnp.where(n2 > eps, 1.0 / jnp.sqrt(jnp.maximum(n2, eps)), 0.0)
    return v * inv[..., None]


def reflect(v: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Mirror reflection of direction v about unit normal n."""
    return v - n * (2.0 * dot(v, n))[..., None]


def refract(
    v: jnp.ndarray,
    n: jnp.ndarray,
    outside_ior: jnp.ndarray,
    inside_ior: jnp.ndarray,
):
    """Snell refraction as in crt_vector.cpp:11-27.

    Args are batched; ``v`` must be unit, ``n`` unit and facing the incoming
    side (callers flip it when exiting a volume, crt_renderer.cpp:115-121).

    Returns ``(direction, ok)`` where ``ok`` is False on total internal
    reflection (the reference's ``sin_alpha > inside_ior / outside_ior`` test).
    Lanes with ``ok == False`` contain a safe dummy direction.
    """
    cos_alpha = -dot(v, n)
    sin_alpha = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_alpha * cos_alpha))
    ok = sin_alpha <= inside_ior / outside_ior

    sin_beta = sin_alpha * outside_ior / inside_ior
    sin_beta = jnp.minimum(sin_beta, 1.0)  # guard masked lanes
    cos_beta = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin_beta * sin_beta))

    tangent = safe_normalize(v + n * cos_alpha[..., None])
    out = tangent * sin_beta[..., None] - n * cos_beta[..., None]
    return out, ok


def rotate_rows(v: jnp.ndarray, m: jnp.ndarray) -> jnp.ndarray:
    """Row-vector times row-major matrix: ``v @ M`` (crt_matrix.h:66-74).

    v: [..., 3], m: [3, 3] (or broadcastable batch of matrices [..., 3, 3]).

    Written elementwise, NOT as ``v @ m``: a default-precision f32 matmul
    may run in reduced precision (TF32 on the GPU); a reduced-precision
    rotation put ~4e-3 relative error on every camera ray direction
    (~1.5% of 09-01's pixels off by >1/255 via shifted hit points and
    flipped shared-edge winners).  Elementwise f32 FMAs are
    exact and fuse into the surrounding ops anyway.
    """
    if m.ndim == 2:
        return (
            v[..., 0:1] * m[0] + v[..., 1:2] * m[1] + v[..., 2:3] * m[2]
        )
    return (
        v[..., 0:1] * m[..., 0, :]
        + v[..., 1:2] * m[..., 1, :]
        + v[..., 2:3] * m[..., 2, :]
    )


def rotation_x(angle: float) -> jnp.ndarray:
    """Row-major rotation about X (crt_matrix.cpp:7-13)."""
    c, s = jnp.cos(angle), jnp.sin(angle)
    return jnp.array([[1.0, 0.0, 0.0], [0.0, c, s], [0.0, -s, c]], jnp.float32)


def rotation_y(angle: float) -> jnp.ndarray:
    """Row-major rotation about Y (crt_matrix.cpp:15-21)."""
    c, s = jnp.cos(angle), jnp.sin(angle)
    return jnp.array([[c, 0.0, -s], [0.0, 1.0, 0.0], [s, 0.0, c]], jnp.float32)


def rotation_z(angle: float) -> jnp.ndarray:
    """Row-major rotation about Z (crt_matrix.cpp:23-29)."""
    c, s = jnp.cos(angle), jnp.sin(angle)
    return jnp.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]], jnp.float32)


def from_axes(right, up, forward) -> jnp.ndarray:
    """Matrix rows = (right, up, forward), batched (crt_matrix.h:28-34).

    right/up/forward: [..., 3] -> [..., 3, 3].
    """
    return jnp.stack([right, up, forward], axis=-2)
