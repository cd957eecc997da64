"""gpuacceleratedtracking_tpu — GNSS baseband tracking framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
coezmaden/GPUAcceleratedTracking (CUDA.jl research code for multi-antenna GNSS
EPL correlation) plus the closed-loop tracking its Tracking.jl dependency
provided: five-family code generation (GPS L1 C/A + L5, GLONASS L1OF,
Galileo E1 BOC(1,1), BeiDou B1I), synthetic signal models, fused
Early/Prompt/Late correlation kernels, PCPS acquisition, on-device DLL/PLL
loops with secondary-code handling, channel banks sharded over device meshes,
and a benchmark harness against the paper's real-time bound.
"""

__version__ = "0.1.0"

from . import acquire, bench, models, ops, parallel, runtime, tracking

__all__ = [
    "acquire", "bench", "models", "ops", "parallel", "runtime", "tracking",
    "__version__",
]
