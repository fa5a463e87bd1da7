"""PyTorch and CUDA port of the OptiReduce reproduction (``src/repro``).

The package mirrors the reference's layout (``core/``, ``kernels/``,
``models/``, ``optim/``, ``train/``, ``launch/``, ...) and imports neither
JAX nor ``repro``. Entry points run on the CUDA device unless the caller
passes ``device="cpu"``.
"""
