"""tpudet_torch: the PyTorch and CUDA port of tpudet for one NVIDIA H100.

The JAX package ``tpudet`` beside it is the reference; each module here has
the path and name of its counterpart there (``tpudet_torch/ops/nms.py`` is
``tpudet/ops/nms.py``). The port imports torch and numpy only. Its kernels
(``tpudet_torch/kernels/csrc``) build with ``nvcc`` at first CUDA use;
importing the package needs no compiler and no GPU.
"""
