"""End-to-end library-surface drive: ply -> scene -> render (3 modes) -> PNG,
pose store round-trip, inspector report, on the platform JAX picks (the
compiled kernels on a GPU, the XLA path on the CPU). Writes under the
repository's `.smoke/verify_surface/`."""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import os
import shutil

import jax

import gsrast_tpu as gs
from gsrast_tpu.render.api import default_backend
from gsrast_tpu.utils.compile_cache import REPO_CACHE_DIR, enable_compile_cache
from gsrast_tpu.utils import image, inspector, posedb
from gsrast_tpu.viz.pointcloud import render_pointcloud
from gsrast_tpu.viz.ellipsoids import render_ellipsoids

enable_compile_cache()
print("backend:", jax.default_backend(), jax.devices()[:1])

tmp = str(REPO_CACHE_DIR.parent / ".smoke" / "verify_surface")
shutil.rmtree(tmp, ignore_errors=True)
os.makedirs(tmp)
scene0 = gs.random_scene(jax.random.PRNGKey(0), 2000, sh_degree=3,
                         scale_range=(0.01, 0.04))
ply_path = os.path.join(tmp, "scene.ply")
gs.save_ply(scene0, ply_path)
scene = gs.load_ply(ply_path)
print("ply roundtrip:", scene.capacity, "gaussians, sh deg", scene.sh_degree)
from gsrast_tpu.scene import native
print("native codec used:", native.available())

mn, mx = scene.bbox()
cam = gs.auto_frame(mn, mx, 512, 256)
cfg = gs.RenderConfig(backend=default_backend(),
                      intersect_capacity_factor=16.0, background=(0.05, 0.05, 0.08))
out = gs.render(scene, cam, cfg)
print("gaussian mode: image", out.image.shape, "mean", float(out.image.mean()),
      "intersections", int(out.stats["num_intersections"]),
      "overflows", int(out.stats["overflow_capacity"]),
      int(out.stats.get("overflow_tile_cap", 0)))
p1 = image.save_png(out.image, os.path.join(tmp, "gaussians.png"))

pc = render_pointcloud(scene.activated(), cam)
p2 = image.save_png(pc, os.path.join(tmp, "pointcloud.png"))
el = render_ellipsoids(scene.activated(), cam)
p3 = image.save_png(el, os.path.join(tmp, "ellipsoids.png"))
print("debug modes:", p2, p3, "pc mean", float(pc.mean()), "el mean", float(el.mean()))

db = posedb.PoseDB(path=os.path.join(tmp, "store.json"))
db.save("home", cam)
cam2 = db.load("home")
assert cam2 is not None and cam2.width == cam.width
print("posedb:", db.names())

rep = inspector.scene_report(scene)
print("inspector: active", rep["num_active"], "bytes", rep["bytes"]["total"])
peek = inspector.peek_gaussian(scene, cam, 0, cfg)
print("peek[0]: radius", peek["radius"], "tiles", peek["tiles_touched"])
print("VERIFY_SURFACE_OK", tmp)
