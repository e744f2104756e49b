"""Camera animation API — the Transform/Camera move surface.

Mirrors the reference's camera-move API (crt_camera.h:26-56 →
crt_transform.h:20-56): dolly/truck/pedestal move along local axes, pan/
tilt/roll compose axis rotations, *_around orbit an anchor.

The reference's ``Matrix::operator*=`` accumulates into the aliased
destination (crt_matrix.h:45-54), corrupting every composed rotation; scene
files are unaffected (they supply matrices verbatim) but the move API
routes through it.  This implementation composes rotations *correctly*;
``buggy_compose=True`` reproduces the reference accumulation for archaeology.

All functions are pure: (position [3], rotation [3,3]) -> new pair, with
the row-vector convention (world = local @ R) throughout.  They are jit- and
grad-compatible, so camera paths can be optimized end-to-end through the
renderer.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from crt_tpu.ops import vecmath


class CameraRig(NamedTuple):
    position: jnp.ndarray  # [3]
    rotation: jnp.ndarray  # [3, 3] row-major, row-vector convention

    @classmethod
    def identity(cls, position=(0.0, 0.0, 0.0)) -> "CameraRig":
        return cls(
            jnp.asarray(position, jnp.float32), jnp.eye(3, dtype=jnp.float32)
        )

    # -- translations (crt_transform.h:20-30) -------------------------------
    def translate_world(self, v) -> "CameraRig":
        return self._replace(position=self.position + jnp.asarray(v, jnp.float32))

    def translate_local(self, v) -> "CameraRig":
        v = jnp.asarray(v, jnp.float32)
        return self._replace(
            position=self.position + vecmath.rotate_rows(v, self.rotation)
        )

    def dolly(self, distance) -> "CameraRig":
        return self.translate_local(jnp.asarray([0.0, 0.0, distance]))

    def truck(self, distance) -> "CameraRig":
        return self.translate_local(jnp.asarray([distance, 0.0, 0.0]))

    def pedestal(self, distance) -> "CameraRig":
        return self.translate_local(jnp.asarray([0.0, distance, 0.0]))

    # -- rotations (crt_transform.h:32-56) -----------------------------------
    def _rotate(self, m, buggy_compose=False) -> "CameraRig":
        if buggy_compose:
            # Reference *= quirk: result starts from the CURRENT rotation and
            # accumulates partial products in place (crt_matrix.h:45-54).
            # Bit-exact emulation: the C++ loop does
            # ``data[i][j] += data[i][k] * rhs[k][j]`` IN PLACE, so at
            # k == j the read of data[i][k] sees the partially accumulated
            # data[i][j] — each k step must commit before the next read.
            r = jnp.array(self.rotation)
            for i in range(3):
                for j in range(3):
                    for k in range(3):
                        r = r.at[i, j].add(r[i, k] * m[k, j])
            return self._replace(rotation=r)
        # rows of the rotation are vectors: compose via the exact-f32
        # rotate_rows (a default-precision `@` may run in TF32)
        return self._replace(rotation=vecmath.rotate_rows(self.rotation, m))

    def pan(self, angle, **kw) -> "CameraRig":
        return self._rotate(vecmath.rotation_y(jnp.float32(angle)), **kw)

    def tilt(self, angle, **kw) -> "CameraRig":
        return self._rotate(vecmath.rotation_x(jnp.float32(angle)), **kw)

    def roll(self, angle, **kw) -> "CameraRig":
        return self._rotate(vecmath.rotation_z(jnp.float32(angle)), **kw)

    def _rotate_around(self, m, anchor, **kw) -> "CameraRig":
        anchor = jnp.asarray(anchor, jnp.float32)
        out = self._rotate(m, **kw)
        return out._replace(
            position=vecmath.rotate_rows(self.position - anchor, m) + anchor
        )

    def pan_around(self, angle, anchor, **kw) -> "CameraRig":
        return self._rotate_around(
            vecmath.rotation_y(jnp.float32(angle)), anchor, **kw
        )

    def tilt_around(self, angle, anchor, **kw) -> "CameraRig":
        return self._rotate_around(
            vecmath.rotation_x(jnp.float32(angle)), anchor, **kw
        )

    def roll_around(self, angle, anchor, **kw) -> "CameraRig":
        return self._rotate_around(
            vecmath.rotation_z(jnp.float32(angle)), anchor, **kw
        )

    def apply(self, scene):
        """Return the scene with this rig's camera."""
        return scene.replace(
            cam_position=self.position, cam_rotation=self.rotation
        )

    @classmethod
    def from_scene(cls, scene) -> "CameraRig":
        return cls(scene.cam_position, scene.cam_rotation)
