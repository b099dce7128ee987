"""geodesic_raytracing — a differentiable geodesic raytracer in JAX.

A from-scratch JAX framework with the capabilities of the reference
C++/OpenCL "Relativity Workshop" renderer: render any analytic metric
tensor in any coordinate system — black holes, wormholes, warp drives,
cosmic strings — plus differentiable rendering of pixels w.r.t. metric
parameters and camera pose, sharded over the GPUs of a host.
"""

__version__ = "0.1.0"

from . import metrics  # noqa: F401  (populates the metric registry)
