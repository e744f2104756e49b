"""Build the native helper library: g++ -O3 -shared -> libcrt_accel.so.

The library is not committed: it is built from the sources here at first
use (crt_tpu.scene.native_accel, crt_tpu.io.native_ppm) or by running this
script, with portable flags so a build is valid on any x86-64 host.
"""

from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRCS = [
    os.path.join(HERE, "crt_accel.cpp"),
    os.path.join(HERE, "crt_ppm.cpp"),
]
OUT = os.path.join(HERE, "libcrt_accel.so")


def build(force: bool = False) -> str:
    if (
        not force
        and os.path.exists(OUT)
        and all(
            os.path.getmtime(OUT) >= os.path.getmtime(s) for s in SRCS
        )
    ):
        return OUT
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC",
        *SRCS, "-o", OUT,
    ]
    subprocess.run(cmd, check=True)
    return OUT


if __name__ == "__main__":
    print(build(force="--force" in sys.argv))
