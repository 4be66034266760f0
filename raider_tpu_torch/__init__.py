"""raider-tpu on PyTorch and CUDA: tropospheric delays for one NVIDIA H100.

The PyTorch port of ``raider_tpu``. It mirrors that package path for path
(``raider_tpu_torch/ops/interp.py`` is the counterpart of
``raider_tpu/ops/interp.py``) and is held against it by the
``tests/test_torch_*.py`` parity tests.

Design:
  * Plain PyTorch on tensors; every public entry point takes a ``device``
    (the CUDA card unless the caller names another) and creates its tensors
    there. Nothing falls back to the CPU when a GPU is missing.
  * Geometry (orbits, ray/level intersections, CRS transforms) runs in torch
    float64 on the device: the H100 computes f64 in hardware, so the JAX
    package's float32-pair (df64) layer has no counterpart here.
  * Data kernels run in float32. The two Pallas kernels on the delay path are
    hand-written CUDA for sm_90a (``csrc/``): the fused refractivity + ZTD
    scan (``ops.ztd``) and the brick integrate (``delay.raytrace``). Each
    has a plain-torch twin, which is also what a CPU tensor runs.
  * The package imports neither jax nor ``raider_tpu``: importing any
    ``raider_tpu`` module turns on jax's x64 mode and its compile cache.
"""

__version__ = '0.1.0'
