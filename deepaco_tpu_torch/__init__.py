"""DeepACO on PyTorch and CUDA: the port of ``deepaco_tpu`` to an NVIDIA H100.

The package mirrors ``deepaco_tpu``'s module names, so each function's JAX
counterpart sits at the same path there. It imports ``torch`` and ``numpy``
only. It covers neural anytime inference for TSP, with and without
neural-guided local search, and REINFORCE training of the TSP heuristic:

- ``utils``  — instance generators, distance matrices, the checkpoint reader
               and writer
- ``core``   — the regular ``[N, K]`` k-NN graph and the TSP-NLS graph
- ``models`` — EmbNet + ParNet heuristic network (``nn.Module``)
- ``ops``    — hand-written CUDA kernels (``csrc/``), their builder and their
               plain PyTorch versions
- ``aco``    — pheromone state, Ant System update, the batched anytime
               runner, the construction engine and the TSP plug-in
- ``eval``   — the anytime evaluation protocol (``evaluate_tsp``)
- ``train``  — configuration and REINFORCE training (``train_tsp``)

Entry points run on ``torch.device("cuda")`` unless the caller passes
``device="cpu"``; with no card they raise (see :mod:`.device`).
"""

__version__ = "0.1.0"
