"""soc_real_time_renderer — a JAX real-time deferred renderer.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of the
reference Vulkan/Daxa renderer ``lukasino1214/soc_real_time_renderer``
(G-buffer deferred shading, shadow mapping, terrain, SSAO, SSR, clouds +
atmosphere, bloom, TAA, histogram auto-exposure, AgX tone mapping),
built as one pure jitted function per frame over a pytree scene:
rasterization is sort-based binning plus a Pallas resolve kernel
(Triton route on the GPU), and all screen-space passes are fused XLA
image ops.

Layout:
  config.py   static RenderConfig + dynamic ShaderGlobals pytrees
  camera.py   perspective/fly cameras + TAA jitter
  scene/      entity-component scene model (ECS analog)
  models/     asset pipeline: glTF meshes, textures/atlas, terrain
  ops/        all render kernels (raster, lighting, post stack)
  graph/      frame-graph assembly: render_frame()
  parallel/   multi-chip meshes and shardings
  utils/      math, image IO, timing
"""

__version__ = "0.1.0"

from .config import RenderConfig, ShaderGlobals, SunInfo, LightArrays  # noqa: F401
from .camera import Camera3D, ControlledCamera3D, InputState  # noqa: F401
