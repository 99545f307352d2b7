"""The benchmark of ``shadow_gnn_torch`` on NVIDIA H100 cards: see
``run.py`` and ``harness.py``."""
