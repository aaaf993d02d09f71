"""gyre-tpu on PyTorch and CUDA: the port of the gyre_tpu package to an
NVIDIA Hopper card.

The JAX package ``gyre_tpu`` stays the reference. This package mirrors its
layout and module names (models/, ops/, pipeline/, manager/, services/,
utils/, server.py), imports torch and never jax, and runs its TPU kernels as
hand-written CUDA kernels (csrc/, built at first use by _build.py).
It imports nothing of gyre_tpu either: the JAX-free modules it needs
(models/configs.py, pipeline/tokenizer.py, manager/scheduler.py,
manager/engines_yaml.py, manager/weights.py, models/ldm.py's rename
tables, services/exception_to_grpc.py, registration.py and dashboard.py,
http/, utils/{timing,cache,resources,logview,debug_recorder}.py, the
protocol stubs and the OpenAPI document under generated/) are copies, at the
same relative paths, held to their originals by
tests/test_torch_vendored.py and tests/test_torch_load.py.
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
