"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each package holds ``ref.py`` (the plain version), ``csrc/*.cu`` (the kernel,
built by ``kernels/build.py``) and ``ops.py`` (the wrapper, with a launch
counter). ``kernels/runtime.py`` decides which one a tensor goes through.
"""
