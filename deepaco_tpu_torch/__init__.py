"""DeepACO on PyTorch and CUDA: the port of ``deepaco_tpu`` to an NVIDIA H100.

The package mirrors ``deepaco_tpu``'s module names, so each function's JAX
counterpart sits at the same path there. It imports ``torch`` and ``numpy``
(and, for the native local-search engine, ``ctypes``) only. It covers
neural anytime inference for TSP, with and without neural-guided local
search, REINFORCE training of the TSP heuristic, the CVRP, OP, PCTSP,
SMTWTP, SOP, BPP, MKP and MKP-items families (inference and training
through the family registry), CVRP-NLS (the CVRP construction polished by
the native SWAP* engine, inference and training), RCPSP, the large-N
sparse-state TSP protocol behind ``python -m deepaco_tpu_torch test tsp
--sparse``, the reference's ``.pt`` checkpoints, the adaptive-elitist CVRP
baseline and the sparse-support batched TSP runner; everything the JAX
package runs on one device:

- ``utils``  — instance generators, the golden sets, distance matrices, the
               checkpoint reader and writer and ``save_params_npz``, the
               CVRPLib and TSPLIB readers (``convert``)
- ``core``   — the regular ``[N, K]`` graph, its blocks, and each family's graph
- ``models`` — EmbNet + ParNet heuristic network (``nn.Module``); the
               MKP-items transformer; ``torch_compat``, the reader of the
               reference's ``.pt`` state dicts
- ``ops``    — hand-written CUDA kernels (``csrc/``), their builder and their
               plain PyTorch versions
- ``ls``     — the native CVRP local-search engine (``native/cvrp_ls.cpp``,
               built with ``g++``) and its ctypes binding
- ``aco``    — pheromone state (matrix and per-item vector), Ant System
               update, the anytime runners (dense, sparse-support
               ``batched_tsp.run_anytime_sparse``, and ``large_tsp`` on the
               ``[N, K]`` support), the construction engine, the problem
               plug-ins and their facades, ``adaptive_cvrp``
               (``AdaptiveCVRPACO``)
- ``families`` — the problem-family registry
- ``eval``   — the TSP and RCPSP anytime evaluation protocols
               (``evaluate_tsp``, ``evaluate_rcpsp``)
- ``train``  — configuration, REINFORCE training (``train_tsp``), the
               training and evaluation of any ported family (``drivers``),
               and ``special``: the RCPSP and CVRP-NLS trainers and the
               MKP-items single-instance step
- ``cli``    — the command line (``train``, ``test``, ``solve-cvrp``)

Entry points run on ``torch.device("cuda")`` unless the caller passes
``device="cpu"``; with no card they raise (see :mod:`.device`).
"""

__version__ = "0.1.0"
