"""bigdl_tpu_torch — the PyTorch/CUDA port of ``bigdl_tpu``.

The JAX package (``bigdl_tpu``) is the reference; this package is its
counterpart for an NVIDIA H100, written in PyTorch with hand-written
Hopper kernels where the JAX package wrote Pallas kernels.  It never
imports ``jax`` or ``bigdl_tpu``.

Public layouts follow the JAX package: activations are NHWC, conv
weights HWIO, Linear weights ``(in, out)``, and every module keeps the
JAX child keys and leaf names, so a JAX ``{"params", "state"}`` tree
loads by name (:func:`bigdl_tpu_torch.utils.convert.load_jax_variables`).

Entry points (model builders, the serving engine) run on the card
unless the caller passes ``device="cpu"``; see :func:`resolve_device`.
"""
from bigdl_tpu_torch.device import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device", "__version__"]
