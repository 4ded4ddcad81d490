"""xrdslam_tpu_torch — the PyTorch/CUDA port of xrdslam_tpu.

Module paths mirror ``xrdslam_tpu`` so that each counterpart is easy to
find. The port runs Co-SLAM (exact per-vertex hash grid) end to end; the
hash-grid encoder's forward and backward are hand-written CUDA kernels for
Hopper (``kernels/hashgrid.cu``), with a plain PyTorch twin that serves CPU
tensors. Importing this package loads no accelerator framework other than
torch and has no side effects.
"""

__version__ = "0.1.0"
