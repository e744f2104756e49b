"""stb_image-exact JPEG decoder tests.

The decisive bit-exactness proof lives in tools/oracle_ref_f32.py: replaying
the reference's exact f32 expression order with this decoder's texels
reproduces the 12-01-textures-scene3 golden with ZERO mismatched pixels
(2,073,600 of 2,073,600 exact, ~336k of them texture-mapped) — so the
decode equals the reference's stbi_load byte-for-byte.  These tests pin
that verified output with a checksum and sanity-check the general paths
(subsampling modes, grayscale, restart intervals, progressive fallback)
against PIL within the known stb-vs-libjpeg skew.
"""

import hashlib
import io

import numpy as np
import pytest

from crt_tpu.io import jpeg_stb

DRAGON = "12-01-textures/textures/dragon.jpg"  # under the scenes corpus

# sha256 of the decode verified bit-exact against the reference golden
# via tools/oracle_ref_f32.py (see module docstring).
DRAGON_SHA = "5b79ed098b632aefddea5c4f754b43242168f33d55f9197df7678d14498a5eab"


def test_dragon_checksum(scenes_dir):
    out = jpeg_stb.decode_file(str(scenes_dir / DRAGON))
    assert out.shape == (360, 540, 3) and out.dtype == np.uint8
    assert hashlib.sha256(out.tobytes()).hexdigest() == DRAGON_SHA


def test_dragon_close_to_pil():
    """stb and libjpeg-turbo agree within a few codes (different integer
    IDCT/color rounding) — catches gross decoder bugs independently of the
    checksum.  Decodes a dragon-sized (540x360, 4:2:0) JPEG of sprite-like
    content encoded here."""
    from PIL import Image

    data = _encode(_sprite_like(360, 540), quality=90)
    ours = jpeg_stb.decode(data).astype(np.int32)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"), np.int32)
    d = np.abs(ours - pil)
    assert d.max() <= 3
    assert (d != 0).mean() < 0.05


def _encode(img: np.ndarray, **save_kwargs) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **save_kwargs)
    return buf.getvalue()


def _rand_img(h, w, seed=0):
    rng = np.random.RandomState(seed)
    # smooth-ish content: random low-res upsampled + noise, so quantized
    # coefficients exercise both EOB-early and dense blocks
    base = rng.randint(0, 256, (h // 8 + 1, w // 8 + 1, 3), np.uint8)
    img = np.kron(base, np.ones((8, 8, 1), np.uint8))[:h, :w]
    noise = rng.randint(-12, 13, (h, w, 3), np.int32)
    return np.clip(img.astype(np.int32) + noise, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("subsampling,maxdiff", [(0, 3), (1, 4), (2, 4)],
                         ids=["444", "422", "420"])
def test_subsampling_modes_vs_pil(subsampling, maxdiff):
    img = _rand_img(50, 70, seed=subsampling)
    data = _encode(img, quality=90, subsampling=subsampling)
    ours = jpeg_stb.decode(data).astype(np.int32)
    from PIL import Image

    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"), np.int32)
    assert ours.shape == pil.shape
    d = np.abs(ours - pil)
    # stb's fancy upsampling and libjpeg's are the same triangle filter
    # with different rounding biases (stb h_2 uses +2/+2 where libjpeg
    # uses +1/+2), so ±2 codes on alternating columns is expected skew.
    assert d.max() <= maxdiff, f"max diff {d.max()}"
    assert (d > 2).mean() < 0.02


def _sprite_like(h, w, seed=1):
    """Shaded shapes on a dark flat background with mild sensor noise —
    the content class of the course's dragon texture."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.full((h, w, 3), [20.0, 24.0, 30.0], np.float32)
    for _ in range(8):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        ry, rx = rng.uniform(15, 70, 2)
        inside = ((y - cy) / ry) ** 2 + ((x - cx) / rx) ** 2 < 1
        shade = rng.uniform(60, 230, 3) * (
            0.75 + 0.25 * np.cos(x / 9.0 + y / 13.0))[..., None]
        img = np.where(inside[..., None], shade, img)
    img += rng.normal(0, 2, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def test_grayscale():
    img = _rand_img(33, 41, seed=7)[:, :, 0]
    data = _encode(img, quality=92)
    ours = jpeg_stb.decode(data).astype(np.int32)
    from PIL import Image

    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"), np.int32)
    assert ours.shape == pil.shape
    assert np.abs(ours - pil).max() <= 1
    # grayscale replicates Y into all three channels
    assert (ours[:, :, 0] == ours[:, :, 1]).all()


def test_restart_intervals():
    img = _rand_img(64, 96, seed=3)
    try:
        data = _encode(img, quality=88, restart_marker_blocks=2)
    except (TypeError, OSError):
        pytest.skip("Pillow without restart marker support")
    assert b"\xff\xdd" in data[:1000]  # DRI present
    ours = jpeg_stb.decode(data).astype(np.int32)
    from PIL import Image

    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"), np.int32)
    assert np.abs(ours - pil).max() <= 3


def test_progressive_raises():
    img = _rand_img(40, 40, seed=5)
    data = _encode(img, quality=85, progressive=True)
    with pytest.raises(jpeg_stb.UnsupportedJPEG):
        jpeg_stb.decode(data)


def test_loader_fallback_for_progressive(tmp_path):
    """json_loader._load_bitmap falls back to PIL on non-baseline JPEGs."""
    from crt_tpu.scene.json_loader import _load_bitmap

    img = _rand_img(24, 24, seed=9)
    p = tmp_path / "prog.jpg"
    p.write_bytes(_encode(img, quality=85, progressive=True))
    arr = _load_bitmap(str(p))
    assert arr.shape == (24, 24, 3) and arr.dtype == np.float32


def test_truncated_raises():
    data = _encode(_sprite_like(360, 540), quality=90)
    with pytest.raises(jpeg_stb.CorruptJPEG):
        jpeg_stb.decode(data[:2])
    # truncated entropy data should still decode (zero-fed), not crash
    out = jpeg_stb.decode(data[: len(data) // 2])
    assert out.shape == (360, 540, 3)
