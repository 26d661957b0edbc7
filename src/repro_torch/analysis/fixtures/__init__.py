"""KNOWN-BAD fixture reproductions of shipped bugs, kept as analyzer
regression tests.  Excluded from the default scan; exercised by
``python -m repro_torch.analysis --selftest`` and tests/test_torch_analysis.py.
These modules are never imported by the engine."""
