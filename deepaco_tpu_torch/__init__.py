"""DeepACO on PyTorch and CUDA: the port of ``deepaco_tpu`` to an NVIDIA H100.

The package mirrors ``deepaco_tpu``'s module names, so each function's JAX
counterpart sits at the same path there. It imports ``torch`` and ``numpy``
only. Its first slice is neural anytime inference for TSP:

- ``utils``  — instance generators, distance matrices, the checkpoint reader
- ``core``   — the regular ``[N, K]`` k-NN graph
- ``models`` — EmbNet + ParNet heuristic network (``nn.Module``)
- ``ops``    — hand-written CUDA kernels (``csrc/``), their builder and their
               plain PyTorch versions
- ``aco``    — pheromone state, Ant System update, the batched anytime runner
- ``eval``   — the anytime evaluation protocol (``evaluate_tsp``)

Entry points run on ``torch.device("cuda")`` unless the caller passes
``device="cpu"``; with no card they raise (see :mod:`.device`).
"""

__version__ = "0.1.0"
