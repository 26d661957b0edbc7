"""PyTorch/CUDA port of the LLMS serving stack.

A second package beside the JAX reference (``src/repro``): the same
module layout, file for file, so each ported module names the
reference module it is held against.  It imports ``torch`` and numpy,
never JAX and nothing of the reference package.  Hot loops that the
reference wrote as Pallas TPU kernels are hand-written CUDA kernels
for Hopper (``csrc/``), each beside a plain PyTorch version
(``kernels/ref.py``) that CPU tensors take.

Entry points (``models.registry.build_model``, ``core.LLMService``,
``launch.serve.main``, ``launch.train.main``) run on the card
(``device="cuda"``) unless the caller passes ``device="cpu"``.  What is not ported yet is listed in ``ROADMAP.md``.
"""
