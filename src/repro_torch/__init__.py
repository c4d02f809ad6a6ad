"""PyTorch/CUDA port of the ``repro`` serving path, its one-device
training step and the paper's synchronous data parallelism.

The JAX package ``repro`` is the reference; this package mirrors its
module names (``configs``, ``models``, ``kernels``, ``serve``, ``train``,
``optim``, ``data``, ``core``, ``api``, ``checkpoint``, ``elastic``,
``launch``) so each module's counterpart is easy to find.  It imports
``torch`` and numpy only -- never ``jax`` and nothing of ``repro``.

``core`` holds the data-parallel collectives (``flat``, ``bucketed``,
``hierarchical`` allreduce on ``torch.distributed``), the strategy
registry and the data-parallel step; ``api.Trainer`` is the facade
over it (``mesh=None``: the sequential reference).  ``checkpoint``
saves and restores in the reference's on-disk format, and ``elastic``
adds the asynchronous writer, fault injection and resuming at another
world size.  The data-parallel
launchers, ``launch.mnist_dnn_dp`` (the paper's MNIST-DNN experiment)
and ``launch.train --dp-strategy``, run under torchrun with an explicit
``--backend`` (nccl: one rank a card; gloo: the CPU, or ranks sharing
a card).

Entry points run on the CUDA card unless the caller passes
``device="cpu"``: on the CPU every kernel wrapper takes its plain
PyTorch version, on a CUDA tensor it launches the hand-written kernel.
"""
