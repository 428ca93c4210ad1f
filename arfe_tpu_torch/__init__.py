"""PyTorch/CUDA port of ``arfe_tpu`` for NVIDIA Hopper.

The models take the JAX package's NHWC images and mirror its parameter names,
so a JAX parameter tree converts 1:1 into a ``state_dict``
(``convert.jax2torch``). The hand-written CUDA kernels live in ``csrc/`` and
are built on first use (``ops.cuda_build``). Entry point:
``arfe_tpu_torch.apis.init_detector``.
"""

__version__ = '0.1.0'
