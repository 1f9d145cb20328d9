"""The benchmark of ``repro_torch``: ``run.py`` runs one cell of
``BENCHMARK.json``; the rest of the folder is its yardstick."""
