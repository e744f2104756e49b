"""Counter-based, batched PCG32 — bit-exact with the reference RNG.

The reference seeds one ``crt::PCG32`` per pixel from its raster coords and
draws uniforms sequentially during diffuse-GI sampling (crt_random.h:10-43,
crt_renderer.cpp:68-71, :150).  To reproduce the *same sample sequence* on a
ray wavefront we carry the generator state per ray as four uint32 planes
(state hi/lo, inc hi/lo) — JAX has no uint64 without global x64 mode, so the
64-bit LCG step is done in 16-bit limbs.

Everything is elementwise uint32 math: vector-friendly, shape-polymorphic, and
identical in sequence to the C++ (verified by tests against a pure-Python
port of the reference implementation).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

_U32 = jnp.uint32

# PCG multiplier 6364136223846793005 = 0x5851F42D4C957F2D
_MUL_HI = 0x5851F42D
_MUL_LO = 0x4C957F2D


class PCGState(NamedTuple):
    """Batched PCG32 state: four uint32 arrays of identical shape."""

    state_hi: jnp.ndarray
    state_lo: jnp.ndarray
    inc_hi: jnp.ndarray
    inc_lo: jnp.ndarray


def _u32(x):
    return jnp.asarray(x, _U32)


def _mul64(a_hi, a_lo, b_hi: int, b_lo: int):
    """(a_hi:a_lo) * (b_hi:b_lo) mod 2^64, b is a Python constant."""
    a0 = a_lo & _u32(0xFFFF)
    a1 = a_lo >> 16
    b0 = _u32(b_lo & 0xFFFF)
    b1 = _u32(b_lo >> 16)

    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1

    mid = (p00 >> 16) + (p01 & _u32(0xFFFF)) + (p10 & _u32(0xFFFF))
    lo = (mid << 16) | (p00 & _u32(0xFFFF))
    hi_ll = p11 + (p01 >> 16) + (p10 >> 16) + (mid >> 16)

    hi = hi_ll + a_lo * _u32(b_hi) + a_hi * _u32(b_lo)
    return hi, lo


def _add64(a_hi, a_lo, b_hi, b_lo):
    lo = a_lo + b_lo
    carry = (lo < a_lo).astype(_U32)
    hi = a_hi + b_hi + carry
    return hi, lo


def _next(state: PCGState):
    """One PCG32 step.  Returns (output uint32, new_state).

    Mirrors crt_random.h:13-19: output derives from the OLD state.
    """
    old_hi, old_lo = state.state_hi, state.state_lo

    mhi, mlo = _mul64(old_hi, old_lo, _MUL_HI, _MUL_LO)
    new_hi, new_lo = _add64(mhi, mlo, state.inc_hi, state.inc_lo)

    # xorshifted = (uint32)(((old >> 18) ^ old) >> 27)
    x_lo = ((old_lo >> 18) | (old_hi << 14)) ^ old_lo
    x_hi = (old_hi >> 18) ^ old_hi
    xorshifted = (x_lo >> 27) | (x_hi << 5)

    rot = old_hi >> 27  # old >> 59
    out = (xorshifted >> rot) | (xorshifted << ((-rot) & _u32(31)))

    return out, PCGState(new_hi, new_lo, state.inc_hi, state.inc_lo)


def make_pcg(raster_x: jnp.ndarray, raster_y: jnp.ndarray) -> PCGState:
    """Deterministic per-pixel seeding (crt_random.h:30-43).

    seed = (x << 32) | y; state = 0; inc = (seed << 1) | 1; advance twice with
    a ``state += seed`` in between.
    """
    x = _u32(raster_x)
    y = _u32(raster_y)
    seed_hi, seed_lo = x, y
    inc_lo = (seed_lo << 1) | _u32(1)
    inc_hi = (seed_hi << 1) | (seed_lo >> 31)

    st = PCGState(jnp.zeros_like(x), jnp.zeros_like(x), inc_hi, inc_lo)
    _, st = _next(st)
    st = PCGState(*_add64(st.state_hi, st.state_lo, seed_hi, seed_lo), st.inc_hi, st.inc_lo)
    _, st = _next(st)
    return st


def uniform(state: PCGState, active=None):
    """Draw U[0,1) per lane (crt_random.h:21-27).

    ``active`` (bool array or None) gates state advancement per lane: inactive
    lanes keep their state so the per-pixel draw sequence matches the
    reference's depth-first recursion order even under wavefront masking.
    Returns (value f32, new_state).
    """
    out, new_state = _next(state)
    bits = _u32(0x3F800000) | (out >> 9)
    val = jax.lax.bitcast_convert_type(bits, jnp.float32) - 1.0

    if active is not None:
        act = jnp.asarray(active, bool)
        new_state = PCGState(
            jnp.where(act, new_state.state_hi, state.state_hi),
            jnp.where(act, new_state.state_lo, state.state_lo),
            state.inc_hi,
            state.inc_lo,
        )
    return val, new_state


def derive(state: PCGState, salt: int) -> PCGState:
    """Fork a decorrelated child stream from ``state``.

    Used by the iterative (bank) wavefront when a diffuse-GI bounce spawns K
    child rays: each child gets a distinct PCG stream (different ``inc``
    selector — PCG streams with different increments are independent
    sequences) seeded from the parent's post-draw state.  The reference's
    depth-first single-stream draw order (crt_renderer.cpp:68-71) cannot be
    reproduced breadth-first (a child's stream position would depend on its
    *siblings'* subtree sizes), so forked streams trade draw-order parity for
    a bounded iteration — equally deterministic, same distribution.
    """
    # ``salt`` may be a Python int or a traced uint32 scalar/array (e.g. the
    # progressive-pass index).  keep inc odd: flip bits above bit 0 only.
    salt = _u32(salt)
    inc_lo = state.inc_lo ^ (salt << 1)
    inc_hi = state.inc_hi ^ (salt >> 31)
    st = PCGState(state.state_hi, state.state_lo, inc_hi, inc_lo)
    _, st = _next(st)
    return st


def salt_stream(state: PCGState, salt) -> PCGState:
    """Per-pass stream salting for progressive accumulation.

    ``salt`` is a (possibly traced) uint32 scalar: pass 0 returns ``state``
    BIT-EXACT (so the first progressive pass reproduces the single-shot
    render), pass k>0 forks a decorrelated stream via ``derive``.  ``None``
    is the identity.
    """
    if salt is None:
        return state
    salt = _u32(salt)
    forked = derive(state, salt)
    keep = salt == _u32(0)
    return PCGState(*(jnp.where(keep, a, b) for a, b in zip(state, forked)))
