"""Benchmark of graphblas_tpu_torch on one CUDA card.

``run.py`` runs one cell of ``BENCHMARK.json`` once.  Everything that
belongs to one configuration, traffic mix or per-layer metric is a file of
its own, found by the name ``BENCHMARK.json`` gives it:

  configs/<config>.json     a graph deployment (source, generator, scale)
  graphs/<generator>.py     an edge generator, in torch on the device
  weights/<kind>.py         an edge-weight draw, in torch on the device
  traffic/<mix>.json        the call a window makes and what it compares
  reference/<name>.py       plain torch: the answer, worked out anew
  metrics/<metric>.py       a per-layer metric: its spans and its reader

Nothing here imports JAX or the JAX package ``graphblas_tpu``; nothing
under ``reference/`` imports ``graphblas_tpu_torch``.
"""
