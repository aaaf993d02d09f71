"""gyre-tpu on PyTorch and CUDA: the port of the gyre_tpu package to an
NVIDIA Hopper card.

The JAX package ``gyre_tpu`` stays the reference. This package mirrors its
layout and module names (models/, ops/, pipeline/, manager/, services/,
utils/, server.py), imports torch and never jax, and runs its TPU kernels as
hand-written CUDA kernels (csrc/, built at first use by _build.py).
JAX-free modules of gyre_tpu (model configs, the coalescing dispatcher, the
tokenizer, the protocol stubs and gRPC registration) are imported, not
copied.
"""

import torch

__version__ = "0.1.0"


def set_matmul_precision():
    """Float32 products stay float32 on the card: TF32 off for both cuBLAS
    matmuls and cuDNN convolutions. The serving path computes in bf16, so
    this touches only f32 work, such as the f32 references the port is
    checked against, which must not silently drop to TF32's ~3 decimal
    digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
