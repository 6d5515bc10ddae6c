"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on the H100:
``BENCHMARK.json`` at the repository's root names its cells; ``run.py`` runs
one."""
