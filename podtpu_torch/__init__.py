"""podtpu_torch: the PyTorch and CUDA port of podtpu, for NVIDIA Hopper.

The JAX package ``podtpu`` is the reference; this package imports nothing
from it.  Ported so far, for Faster R-CNN ResNet-50-FPN: serving
(``infer.server.DetectionServer``), the train step (``train.step``), the
training driver and saved-model evaluation (``train.train``), batch
inference (``infer.inference.infer``, ``infer_directory``) and cropping
(``infer.crop``), with hand-written CUDA kernels for NMS, RoIAlign forward
and RoIAlign backward under ``csrc/``.
"""
