"""xrdslam_tpu_torch — the PyTorch/CUDA port of xrdslam_tpu.

Module paths mirror ``xrdslam_tpu`` so that each counterpart is easy to
find. The port runs the per-frame paths of Co-SLAM (exact per-vertex hash
grid), SplaTAM and Point-SLAM end to end. Each TPU kernel on those paths is
a hand-written CUDA kernel for Hopper in ``kernels/`` (hash-grid encoder,
tile rasterizer, row scatter-add, row gather), with a plain PyTorch twin
that serves CPU tensors. Importing this package loads no accelerator
framework other than torch and has no side effects.
"""

__version__ = "0.1.0"
