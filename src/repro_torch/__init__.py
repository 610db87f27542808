"""FedCore in PyTorch, for NVIDIA Hopper (H100).

A port of the JAX package ``repro`` that stays beside it: the same
modules under the same names, with PyTorch for the tensor code and
hand-written CUDA C++ kernels (``repro_torch.kernels``) where the JAX
package has Pallas TPU kernels.  It imports nothing of ``repro`` and no
JAX; the parity tests import both.

Importing this package loads nothing heavy: submodules import ``torch``
themselves, and the CUDA kernels are compiled at their first launch.
"""

__version__ = "0.1.0"
