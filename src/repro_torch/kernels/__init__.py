"""Hand-written CUDA kernels of the selection path and their wrappers.

``csrc/`` holds the CUDA C++ sources (built by ``_build`` at first use),
``ref`` the plain PyTorch versions, ``ops`` the wrappers that pick one by
the tensors' device and count launches.
"""
