"""cudapathtracer — a differentiable path tracer in JAX.

A JAX/XLA re-design of the capabilities of the CUDA reference renderer
(CulDeVu/CUDAPathTracer): OBJ/MTL scenes, binned-SAH BVH, thin-lens camera
with Morton pixel order, Lambertian BSDF + area lights, PT+NEE and fixed
2+3 BDPT integrators, progressive resumable accumulation, PPM output —
plus differentiable rendering (pixel gradients w.r.t. scene parameters)
and multi-device sharding over a jax device mesh. It runs on an NVIDIA
H100 and, for tests, on the CPU.

See SURVEY.md at the repo root for the reference structural analysis this
framework is built against.
"""

__version__ = "0.1.0"

from .models.scene import Scene, make_scene, merge_scenes  # noqa: F401
from .models.loader import load_obj, load_objs             # noqa: F401
from .render.camera import Camera, make_camera             # noqa: F401
from .render.renderer import (                             # noqa: F401
    AccumState,
    finalize_image,
    init_accum,
    render,
    render_batch,
    write_render,
)
from .utils.config import RenderConfig                     # noqa: F401
