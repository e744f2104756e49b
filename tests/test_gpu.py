"""The compiled Triton kernels on the card (skipped without a GPU).

Run on the card with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu``;
chip_smoke.py drives the same kernels at full 1080p width.
"""

import numpy as np
import jax
import pytest

from crt_tpu.ops import camera as camera_ops
from crt_tpu.ops.pallas_trace import make_pallas_trace_fn
from crt_tpu.scene.procedural import make_test_scene


@pytest.mark.gpu
def test_compiled_walk_matches_interpret(gpu_device):
    scene = make_test_scene(width=64, height=40, num_quads=12,
                            with_reflective=False)
    o, d = camera_ops.generate_rays(
        scene.cam_position, scene.cam_rotation, scene.cam_tan_half_fov,
        scene.width, scene.height,
    )
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    with jax.default_device(gpu_device):
        compiled = jax.jit(make_pallas_trace_fn(scene))(o, d)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        interp = make_pallas_trace_fn(scene, interpret=True)(o, d)
    np.testing.assert_array_equal(np.asarray(compiled.tri) >= 0,
                                  np.asarray(interp.tri) >= 0)
    hits = np.asarray(interp.tri) >= 0
    np.testing.assert_allclose(np.asarray(compiled.t)[hits],
                               np.asarray(interp.t)[hits], rtol=1e-5)
