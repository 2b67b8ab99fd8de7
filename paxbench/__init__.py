"""The benchmark of ``tpu_paxos_torch`` (the PyTorch and CUDA port).

``python -m paxbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and
prints one JSON line.  Everything a cell needs is found by name:
``configs/<config>.json``, ``traffic/<mix>.json`` (whose ``kind`` names
``traffic/<kind>.py``) and ``metrics/<metric>.py``.  The plain reference
that decides ``correct`` is in ``reference/``; the frozen arithmetic
(generators, rooflines, profiler sums) in ``yardstick.py`` and
``trace.py``.  Nothing here imports ``jax`` or the JAX package.
"""
