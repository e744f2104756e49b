"""CLI contract tests (src/standalone/main.cpp semantics)."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(args, cwd=REPO):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, "-m", "crt_tpu.frontend.cli", *args],
        capture_output=True, text=True, cwd=cwd, env=env, timeout=240,
    )


@pytest.fixture(scope="module")
def tiny_scene(tmp_path_factory):
    d = {
        "settings": {
            "background_color": [0, 0.5, 0],
            "image_settings": {"width": 16, "height": 8},
        },
        "camera": {"matrix": [1, 0, 0, 0, 1, 0, 0, 0, 1],
                   "position": [0, 0, 0]},
        "materials": [
            {"type": "diffuse", "albedo": [1, 0, 0], "smooth_shading": False}
        ],
        "objects": [{"material_index": 0,
                     "vertices": [-1, -1, -3, 1, -1, -3, 0, 1, -3],
                     "triangles": [0, 1, 2]}],
        "lights": [{"intensity": 100, "position": [0, 2, 0]}],
    }
    p = tmp_path_factory.mktemp("scene") / "tiny.crtscene"
    p.write_text(json.dumps(d))
    return str(p)


def test_cli_renders_and_prints_timing(tiny_scene, tmp_path):
    out = str(tmp_path / "out.ppm")
    r = run_cli([tiny_scene, out])
    assert r.returncode == 0, r.stderr
    assert "Execution time:" in r.stdout and "seconds." in r.stdout
    from crt_tpu.io.ppm import read_ppm

    img = read_ppm(out)
    assert img.shape == (8, 16, 3)


def test_cli_bad_scene_exits_nonzero(tmp_path):
    r = run_cli(["/nonexistent.crtscene", str(tmp_path / "x.ppm")])
    assert r.returncode == 1
    assert "Could not parse scene file" in r.stderr


def test_cli_aov_flag(tmp_path):
    """--aov renders the auxiliary pass through the same CLI contract."""
    import subprocess
    import sys

    import json

    from crt_tpu.scene.procedural import course_benchmark_dict

    scene_path = tmp_path / "seeded.crtscene"
    scene_path.write_text(json.dumps(course_benchmark_dict(32, 18, seed=4)))
    out = tmp_path / "bary.ppm"
    r = subprocess.run(
        [sys.executable, "-m", "crt_tpu.frontend.cli",
         str(scene_path),
         str(out), "--aov", "bary", "--width", "64", "--height", "36"],
        capture_output=True, text=True,
        env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"},
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "Execution time:" in r.stdout
    txt = out.read_text()
    assert txt.startswith("P3\n64 36\n255\n")
