"""Render the triangle bench's 12-cube orbital scene (147k triangles on a
Schwarzschild r=4 orbit) through the worklist-compacted intersector and
composite the hits (local-frame normal shading, render_chunked_tris
cl.cl:4700-4720) over the production sky render.

Output: docs/triangle_demo.png — the blue annulus is the lensed ring of
camera-facing cube top faces, red bands are side faces at grazing
geometry near the photon ring, and the central images are cubes between
the camera and the horizon (visible IN FRONT of the shadow), with zero
dropped candidates.

Usage: PYTHONPATH=. python scripts/triangle_demo.py   (run on the card)
"""
import sys, time
sys.path.insert(0, ".")
import numpy as np
import jax, jax.numpy as jnp

from geodesic_raytracing import metrics
from geodesic_raytracing.camera import Camera
from geodesic_raytracing.ops import integrate
from geodesic_raytracing.ops.integrate import Features, TraceOptions
from geodesic_raytracing.render import background as bg, colour
from geodesic_raytracing.render import pipeline as pl
from geodesic_raytracing.render.pipeline import RenderSettings
from geodesic_raytracing.triangles import (
    TriangleScene, make_cube, precompute_object, subtriangulate)
from geodesic_raytracing.triangles.render import intersect_scene_compact

m = metrics.get_metric("schwarzschild")
params = m.params()
feats = Features.for_metric(m)
n_obj, tris = 12, 100_000
per_obj = tris // n_obj
depth = max(0, int(np.ceil(np.log(per_obj / 12) / np.log(4))))
max_edge = 1.5 / (2 ** depth) + 1e-6
base = make_cube([0, 0, 0, 0], scale=0.6)
v, t = subtriangulate(base.vertices, base.triangles, max_edge=max_edge)
objs = []
for i in range(n_obj):
    ang = 2 * np.pi * i / n_obj
    v_circ = 0.408
    o = make_cube([-6.0, 4 * np.cos(ang), 4 * np.sin(ang), 0.0], scale=0.6,
                  velocity=(v_circ * -np.sin(ang), v_circ * np.cos(ang), 0))
    o.vertices, o.triangles = v, t
    objs.append(o)
scene = TriangleScene.build(objs)
geos = [precompute_object(m, o, params, feats, n_steps=512, segments=8)
        for o in objs]

W, H = 960, 540
cam = Camera.default().rotate(pitch=-np.pi / 2)
settings = RenderSettings(width=W, height=H,
                          trace=TraceOptions(max_steps=256, method="scan"))
state, _, _ = pl.init_camera_rays(m, cam, params, settings, feats)
final, path = integrate.trace_rays_recorded(
    m, state, params, features=feats, opts=settings.trace,
    n_slots=32, steps_per_slot=8)
t0 = time.perf_counter()
jrun = jax.jit(lambda p: intersect_scene_compact(
    m, p, scene, geos, params, block=256, obj_budget=8,
    pair_budget=524288, tri_budget=1048576))
hit, col = jrun(path)
hit_n = np.asarray(hit); col_n = np.asarray(col)
print(f"hits {hit_n.sum()} in {time.perf_counter()-t0:.1f}s", flush=True)

# Background sky render (full quality) + composite.
sky = pl.render_frame(m, cam, params, bg.checker_background(),
                      RenderSettings(width=W, height=H, anisotropy=4,
                                     trace=TraceOptions(max_steps=4096)),
                      feats)
sky = np.asarray(colour.lin_to_srgb(sky))
img = np.clip(sky, 0, 1)
hm = hit_n.reshape(H, W)
cm = np.abs(col_n.reshape(H, W, 3))
img = np.where(hm[..., None], cm, img)
import imageio.v3 as iio
iio.imwrite("docs/triangle_demo.png",
            (img * 255).astype(np.uint8))
print("wrote docs/triangle_demo.png")
