"""PyTorch/CUDA port of the FiCCO system (``repro`` is the JAX reference).

The layout mirrors ``repro``: ``configs``, ``parallel``, ``tune``,
``kernels``, ``models``, ``serve``, ``launch``.  Every entry point takes
``device=None``, which means ``"cuda"``; with no CUDA device it raises
rather than running on the CPU.  Tests pass ``device="cpu"``, where each
kernel wrapper takes its plain PyTorch version.
"""
