"""Derivation of the 07-01-scene era shading rule from the committed renders.

The 07-01 course tag's source is not in the reference snapshot (only HEAD is,
and HEAD's loader rejects the material-less 07-* scenes, crt_json.cpp:590-592).
The committed goldens (results/png/07-01-scene-scene{0..4}.png) are the only
record of what that tag rendered.  This script reconstructs the rule:

    gray = 0.5 + 0.5 * dot(face_normal, L)        (all three channels)
    L    = (0.3809265, 0.7244545, 0.5750355)      (ops/shade.ERA07_LIGHT_DIR)

with face_normal the CCW geometric normal (normalize(cross(v1-v0, v2-v0)),
crt_triangle.h ctor), plain closest-hit visibility, no culling, background on
miss, and the PPM writer's truncation quantization (crt_image_ppm.cpp:16-19).

Method (run this script to re-verify):
 1. For each of scene1/scene3/scene4, ray-cast a brute-force closest-hit
    triangle-id map (f64, camera model per crt_camera.cpp:7-35) and collect
    every triangle whose golden pixels are a single flat 8-bit gray
    (>=93% mode share over >=60 pixels at half res) -> 162 (gray, normal)
    observations.
 2. A least-squares fit of gray/255 = c + n.L gives c = 0.4989,
    |L| = 0.4990, rms residual 0.28 gray levels -> model: half-lambert.
 3. The PPM writer TRUNCATES (int(c*255)), so each observation is an exact
    interval constraint g/255 <= c + n.L < (g+1)/255.  Linear programming
    over all observations with c = 0.5 fixed bounds each component of
    Lhat = 2L to +-6e-4; ERA07_LIGHT_DIR is the Chebyshev center of the
    feasible polytope (max-slack interior point, radius 5.7e-5).  EVERY
    flat-region observation (162/162) is reproduced EXACTLY under
    truncation, in f64 and f32.
 4. Cross-check: scene0/scene2 (previously modeled as a flat 200 gray) have
    all triangles at n = (0,0,1); the rule predicts
    floor(255 * (0.5 + 0.5*0.57504)) = floor(200.82) = 200 — the same rule
    explains the whole era.

Result (golden sweep): scene0 1.0000, scene1 0.9996, scene2 0.9998,
scene3 1.0000, scene4 1.0000 pixel match (residuals are silhouette-edge
visibility flips from f32 op order, same class as the other goldens).
"""

from __future__ import annotations

import json
import pathlib
import sys

import numpy as np
from PIL import Image

SCENES = pathlib.Path("/root/reference/scenes/07-01-scene")
PNG = pathlib.Path("/root/reference/results/png")


def observations(scene: str, W=960, H=540, minpix=60, minshare=0.93):
    """(gray, unit face normal) for every flat single-gray golden region."""
    d = json.load(open(SCENES / f"{scene}.crtscene"))
    cam = d["camera"]
    O = np.array(cam["position"], np.float64)
    M = np.array(cam["matrix"], np.float64).reshape(3, 3)
    tris = []
    for obj in d["objects"]:
        v = np.array(obj["vertices"], np.float64).reshape(-1, 3)
        idx = np.array(obj["triangles"], np.int64).reshape(-1, 3)
        for t in idx:
            tris.append(v[t])
    tris = np.array(tris)

    x = (np.arange(W) + 0.5) / W * 2 - 1
    y = 1 - (np.arange(H) + 0.5) / H * 2
    X, Y = np.meshgrid(x * (W / H), y)
    dirs = np.stack([X, Y, -np.ones_like(X)], -1) @ M
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    R = dirs.reshape(-1, 3)

    va, vb, vc = tris[:, 0] - O, tris[:, 1] - O, tris[:, 2] - O
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    nn = n / np.linalg.norm(n, axis=-1, keepdims=True)
    bt = np.full(len(R), np.inf)
    bi = np.full(len(R), -1)
    for i in range(len(tris)):
        denom = R @ nn[i]
        with np.errstate(all="ignore"):
            t = (va[i] @ nn[i]) / denom
        p = R * t[:, None]
        h = (
            (t > 0)
            & (np.cross(vb[i] - va[i], p - va[i]) @ nn[i] >= 0)
            & (np.cross(vc[i] - vb[i], p - vb[i]) @ nn[i] >= 0)
            & (np.cross(va[i] - vc[i], p - vc[i]) @ nn[i] >= 0)
        )
        c = h & (t < bt)
        bt = np.where(c, t, bt)
        bi = np.where(c, i, bi)
    bi = bi.reshape(H, W)
    g = np.asarray(
        Image.open(PNG / f"07-01-scene-{scene}.png").convert("RGB")
    )[1::2, 1::2]
    obs = []
    for i in np.unique(bi):
        if i < 0:
            continue
        m = bi == i
        if m.sum() < minpix:
            continue
        vals = g[..., 0][m]
        u, c = np.unique(vals, return_counts=True)
        mode, share = u[np.argmax(c)], c.max() / c.sum()
        if share < minshare:
            continue
        obs.append((int(mode), nn[i]))
    return obs


def main():
    allobs = []
    for s in ["scene1", "scene3", "scene4"]:
        o = observations(s)
        allobs += o
        print(f"{s}: {len(o)} flat observations")
    N = np.array([o[1] for o in allobs])
    G = np.array([o[0] for o in allobs], np.float64)

    # step 2: unconstrained LSQ
    A = np.hstack([N, np.ones((len(N), 1))])
    w, *_ = np.linalg.lstsq(A, G / 255.0, rcond=None)
    print(f"LSQ: c={w[3]:.5f} |L|={np.linalg.norm(w[:3]):.5f} "
          f"rms={np.sqrt((((A @ w) - G / 255.0) ** 2).mean()) * 255:.3f}/255")

    # step 3: exact truncation bounds with c = 0.5
    from scipy.optimize import linprog

    A_ub, b_ub = [], []
    for gi, ni in zip(G, N):
        A_ub.append(-0.5 * ni)
        b_ub.append(0.5 - gi / 255.0)
        A_ub.append(0.5 * ni)
        b_ub.append((gi + 1) / 255.0 - 0.5 - 1e-12)
    A_ub, b_ub = np.array(A_ub), np.array(b_ub)
    for j, nm in enumerate("xyz"):
        lo = linprog(np.eye(3)[j], A_ub=A_ub, b_ub=b_ub,
                     bounds=[(None, None)] * 3, method="highs")
        hi = linprog(-np.eye(3)[j], A_ub=A_ub, b_ub=b_ub,
                     bounds=[(None, None)] * 3, method="highs")
        assert lo.success and hi.success, "infeasible — model wrong"
        print(f"Lhat.{nm} in [{lo.x[j]:.6f}, {hi.x[j]:.6f}]")
    # Chebyshev center: the max-slack interior point (truncation never sits
    # on a boundary) — this is ERA07_LIGHT_DIR.
    norms = np.linalg.norm(A_ub, axis=1, keepdims=True)
    r = linprog(
        np.array([0, 0, 0, -1.0]),
        A_ub=np.hstack([A_ub, norms]),
        b_ub=b_ub,
        bounds=[(None, None)] * 3 + [(0, None)],
        method="highs",
    )
    L = r.x[:3]
    print(f"Chebyshev center: {L}  (radius {r.x[3]:.2e}, |L|="
          f"{np.linalg.norm(L):.6f})")

    # exactness: every observation reproduced under truncation, f64 and f32
    pred = np.floor((0.5 + 0.5 * (N @ L)) * 255)
    exact = int((pred == G).sum())
    L32 = L.astype(np.float32)
    pred32 = np.floor(
        (0.5 + 0.5 * (N.astype(np.float32) @ L32)).astype(np.float32) * 255
    )
    exact32 = int((pred32 == G).sum())
    print(f"exact reproductions: f64 {exact}/{len(G)}, f32 {exact32}/{len(G)}")

    # step 4: scene0/scene2 cross-check
    val = 0.5 + 0.5 * L[2]
    print(f"n=(0,0,1) -> floor({val * 255:.2f}) = {int(val * 255)} "
          f"(scene0/scene2 golden gray: 200)")
    return 0 if exact == len(G) else 1


if __name__ == "__main__":
    sys.exit(main())
