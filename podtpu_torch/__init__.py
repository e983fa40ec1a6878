"""podtpu_torch: the PyTorch and CUDA port of podtpu, for NVIDIA Hopper.

The JAX package ``podtpu`` is the reference; this package imports nothing
from it.  Ported so far: serving Faster R-CNN ResNet-50-FPN
(``infer.server.DetectionServer``), with hand-written CUDA kernels for NMS
and RoIAlign forward under ``csrc/``.
"""
