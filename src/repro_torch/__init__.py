"""PyTorch/CUDA port of the ``repro`` serving path and its one-device
training step.

The JAX package ``repro`` is the reference; this package mirrors its
module names (``configs``, ``models``, ``kernels``, ``serve``, ``train``,
``optim``, ``data``, ``launch``) so each module's counterpart is easy to
find.  It imports
``torch`` and numpy only -- never ``jax`` and nothing of ``repro``.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``: on the CPU every kernel wrapper takes its plain
PyTorch version, on a CUDA tensor it launches the hand-written kernel.
"""
