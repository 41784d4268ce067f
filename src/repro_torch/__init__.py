"""PyTorch/CUDA port of the RCC simulator (``src/repro`` is the JAX reference).

The package mirrors ``repro``'s layout and module names.  It imports
``torch``, ``numpy`` and the standard library only: never ``jax`` and
nothing of ``repro``.  Entry points run on ``device="cuda"`` unless the
caller asks for the CPU.  The front door is :mod:`repro_torch.api`.
"""
