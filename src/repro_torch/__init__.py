"""repro_torch — the PyTorch/CUDA port of the JAX LM framework in ``repro``.

The package mirrors ``repro``'s module names and imports only ``torch`` and
numpy: it never imports ``jax`` or anything under ``repro.``, and keeps its
own copies of what it needs (``configs/``).  The Pallas TPU kernels of
``repro.kernels`` are hand-written CUDA C++ for Hopper here
(``kernels/csrc/*.cu``), and they *are* the layers' compute: every RMSNorm,
prefill attention and projection of the dense model goes through one.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; on the CPU each kernel wrapper takes its plain PyTorch
version.  Ported so far: the serving path (``launch/serve.py`` ->
``serve/engine.py`` -> ``models/model.py``) for the dense family.
"""
