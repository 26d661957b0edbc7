"""Hand-written Hopper kernels (``csrc/*.cu``), their ctypes wrappers,
the plain PyTorch versions (``ref.py``) and the dispatch (``ops.py``)."""
