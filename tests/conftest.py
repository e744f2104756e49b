"""Test configuration: the CPU backend with 8 virtual devices.

Sharding tests need multiple devices, so everything runs on the CPU
backend with 8 virtual devices (must be set before jax initialises a
backend).  Tests that need the GPU are marked ``gpu`` and take the
``gpu_device`` fixture, which skips them here.
"""

import os

# The CPU unless the caller names platforms (``JAX_PLATFORMS=cuda,cpu
# pytest -m gpu`` runs the GPU-marked tests on the card).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pathlib

import numpy as np
import pytest

REFERENCE = pathlib.Path("/root/reference")
SCENES = REFERENCE / "scenes"
GOLDEN_PNG = REFERENCE / "results" / "png"


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX finds none.  Decided
    here, when the test runs, never at import or collection time."""
    import jax

    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a GPU (run chip_smoke.py on the card)")
    return devices[0]


@pytest.fixture(scope="session")
def scenes_dir():
    if not SCENES.exists():
        pytest.skip("reference scenes not available")
    return SCENES


@pytest.fixture(scope="session")
def golden_dir():
    if not GOLDEN_PNG.exists():
        pytest.skip("reference golden renders not available")
    return GOLDEN_PNG


def load_golden(name: str) -> np.ndarray:
    """Load a golden PNG as float32 [H,W,3] in [0,1]."""
    from PIL import Image

    with Image.open(GOLDEN_PNG / f"{name}.png") as im:
        return np.asarray(im.convert("RGB"), np.float32) / 255.0


def golden_match_stats(render: np.ndarray, golden: np.ndarray, tol=2.5 / 255.0):
    """Fraction of pixels within tol per channel + mean abs error.

    The render is quantized with the PPM writer's clamp rule first — goldens
    are 8-bit clamped images.
    """
    from crt_tpu.io.ppm import quantize

    render = quantize(np.asarray(render, np.float32)) / 255.0
    diff = np.abs(render - golden)
    frac = float(np.mean(np.all(diff <= tol, axis=-1)))
    return frac, float(diff.mean())
