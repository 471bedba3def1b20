"""The benchmark of ``rrtmgp_tpu_torch`` on one NVIDIA H100: the harness
(``run.py``), its seeded inputs, the plain-torch reference that decides
``correct``, and the readers of its metrics. See ``README.md``."""
