"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 fabric_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``: a configuration
(``configs/<name>.json``) under a traffic mix (``traffic/<mix>.json``),
its per-layer metrics read by ``metrics/<metric>.py``, its correctness
held to ``limits/<cell>.json`` against the plain reference in
``reference/``.  Nothing here imports JAX or the JAX package.
"""
