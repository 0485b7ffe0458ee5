"""The benchmark of the PyTorch and CUDA port (``skycomputing_tpu_torch``).

``run.py`` is the command; ``harness/`` holds the general code (cell
lookup, traffic, work counts, peaks, the device trace, the checks),
``loops/`` one module per loop kind, ``configs/``, ``traffic/`` and
``metrics/`` one file per configuration, cell and per-layer metric, and
``reference/`` the plain float32 models that decide ``correct``.
"""
