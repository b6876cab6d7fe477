"""DeepACO on PyTorch and CUDA: the port of ``deepaco_tpu`` to an NVIDIA H100.

The package mirrors ``deepaco_tpu``'s module names, so each function's JAX
counterpart sits at the same path there. It imports ``torch`` and ``numpy``
only. It covers neural anytime inference for TSP, with and without
neural-guided local search, REINFORCE training of the TSP heuristic, the
CVRP, OP, PCTSP and SMTWTP families (inference and training through the
family registry), and the large-N sparse-state TSP protocol behind
``python -m deepaco_tpu_torch test tsp --sparse``:

- ``utils``  — instance generators, the golden CVRP, OP, PCTSP and SMTWTP
               sets, distance matrices, the checkpoint reader and writer
- ``core``   — the regular ``[N, K]`` k-NN graph, the TSP-NLS, CVRP, OP,
               PCTSP and SMTWTP graphs
- ``models`` — EmbNet + ParNet heuristic network (``nn.Module``)
- ``ops``    — hand-written CUDA kernels (``csrc/``), their builder and their
               plain PyTorch versions
- ``aco``    — pheromone state, Ant System update, the anytime runners
               (dense, and ``large_tsp`` on the ``[N, K]`` support), the
               construction engine, the TSP, CVRP, OP, PCTSP and SMTWTP
               plug-ins and their facades
- ``families`` — the problem-family registry (``tsp``, ``cvrp``, ``op``,
               ``pctsp``, ``smtwtp``)
- ``eval``   — the TSP anytime evaluation protocol (``evaluate_tsp``)
- ``train``  — configuration, REINFORCE training (``train_tsp``), and the
               training and evaluation of any ported family (``drivers``)
- ``cli``    — the command line (``train``, ``test`` of the ported families,
               ``test tsp --sparse``)

Entry points run on ``torch.device("cuda")`` unless the caller passes
``device="cpu"``; with no card they raise (see :mod:`.device`).
"""

__version__ = "0.1.0"
