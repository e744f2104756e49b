"""ASCII PPM (P3) image I/O.

Writer reproduces the reference byte format exactly (crt_image_ppm.cpp:9-23):
header ``P3\\n<w> <h>\\n<max>\\n``, per pixel ``r g b\\t`` with a newline per
row, channels quantized as ``clamp(int(c * max), 0, max)`` — C truncation
toward zero, no gamma.
"""

from __future__ import annotations

import numpy as np


def quantize(image: np.ndarray, max_color_component: int = 255) -> np.ndarray:
    """float [H,W,3] -> int array with the reference clamp rule.

    f32 multiply + truncate-toward-zero + clamp — exactly
    ``clamp(int(color * max), 0, max)`` where the reference's Color*int
    promotes to FLOAT (crt_image_ppm.cpp:16-19), not double.
    """
    arr = np.asarray(image, np.float32) * np.float32(max_color_component)
    # casting to int truncates toward zero == static_cast<int>; clamp the
    # float first so out-of-int32-range values (inf lanes) stay defined
    arr = np.clip(arr, -2147483000.0, 2147483000.0).astype(np.int32)
    return np.clip(arr, 0, max_color_component)


def format_ppm(image, max_color_component: int = 255) -> str:
    """Format a [H,W,3] float image as an ASCII P3 string.

    Routes through the native formatter (native/crt_ppm.cpp — the Python
    string loop costs ~1.3 s of host time for a 1080p frame) and
    falls back to the byte-identical Python implementation when the
    native library is unavailable.
    """
    arr = quantize(np.asarray(image), max_color_component)
    h, w, _ = arr.shape

    try:
        from crt_tpu.io.native_ppm import format_ppm_native

        return format_ppm_native(arr, max_color_component)
    except Exception:
        pass

    lines = [f"P3\n{w} {h}\n{max_color_component}\n"]
    flat = arr.reshape(h, w * 3)
    for row in flat:
        it = iter(row.tolist())
        lines.append(
            "".join(f"{r} {g} {b}\t" for r, g, b in zip(it, it, it)) + "\n"
        )
    return "".join(lines)


def write_ppm(image, path_or_file, max_color_component: int = 255) -> None:
    """Write a [H,W,3] float image as ASCII P3."""
    data = format_ppm(image, max_color_component)
    if hasattr(path_or_file, "write"):
        path_or_file.write(data)
    else:
        with open(path_or_file, "w") as f:
            f.write(data)


def read_ppm(path_or_file) -> np.ndarray:
    """Read ASCII P3 -> float32 [H,W,3] in [0,1] (values / max)."""
    if hasattr(path_or_file, "read"):
        text = path_or_file.read()
    else:
        with open(path_or_file) as f:
            text = f.read()
    tokens = text.split()
    assert tokens[0] == "P3", "only ASCII P3 supported"
    w, h, maxc = int(tokens[1]), int(tokens[2]), int(tokens[3])
    vals = np.array(tokens[4 : 4 + w * h * 3], dtype=np.float32)
    return (vals / maxc).reshape(h, w, 3)
