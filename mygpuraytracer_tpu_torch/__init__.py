"""mygpuraytracer_tpu_torch — the path tracer and denoiser in PyTorch and CUDA.

The port of ``mygpuraytracer_tpu`` (JAX) to PyTorch on an NVIDIA H100. Its
layout mirrors the JAX package, so each module's counterpart has the same
path:

- ``scene``   : scene.txt parser, OBJ ingestion, builtin scenes, device scene
- ``ops``     : threefry RNG (bit-exact with ``jax.random``), SoA vec3 math,
                primitive and mesh intersection (the mesh tiers' CUDA
                kernel), texel fetches
- ``render``  : camera rays, shading, the wavefront sample, the K1 CUDA
                kernel that runs whole iterations, the Renderer
- ``utils``   : PNG read and write on zlib alone; PFM, HDR, EXR and NPY I/O
- ``denoise`` : TZA weights, transfer functions, the U-Net as an nn.Module,
                the OIDN-style Device/Filter API with tiled execute and
                device-resident DeviceBuffers
- ``train``   : the denoiser's training toolkit: SSIM and the losses, tile
                datasets and rendered training pairs, the host-fed and
                device-resident trainers, export to TZA, Infer, find_lr
- ``apps``    : the ``raytrace``, ``denoise`` (oidnDenoise), ``benchmark``,
                ``preprocess``, ``compare_image``, ``visualize`` and
                ``train_denoiser`` command lines
- ``csrc``    : hand-written CUDA C++ for sm_90a, built by ``_build.py``

It imports torch and numpy, never jax nor the JAX package. Entry points take
a ``device`` argument that defaults to ``"cuda"``; the CPU runs only when a
caller asks for it.
"""

__version__ = "0.1.0"
