"""repro_torch — the PyTorch/CUDA port of the JAX LM framework in ``repro``.

The package mirrors ``repro``'s module names and imports only ``torch`` and
numpy: it never imports ``jax`` or anything under ``repro.``, and keeps its
own copies of what it needs (``configs/``, ``core/``, ``api/``, ``simmpi/``,
``linalg/``).  The Pallas TPU kernels of
``repro.kernels`` are hand-written CUDA C++ for Hopper here
(``kernels/csrc/*.cu``), and they *are* the layers' compute: every RMSNorm,
prefill attention and projection of the dense model goes through one.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; on the CPU each kernel wrapper takes its plain PyTorch
version.  Ported so far, for the dense family: the serving path
(``launch/serve.py`` -> ``serve/engine.py`` -> ``models/model.py``), the
wall-clock tuning loop (``tune/lm_study.py`` -> ``api/session.py`` ->
``api/backends.py`` ``WallClockBackend``), whose kernels run forward and
backward through the CUDA kernels (``kernels/ops.py``'s autograd
Functions; ``train/optim.py`` for AdamW), and the always-on tuning daemon
(``launch/serve.py --daemon`` -> ``serve/tuner.py`` -> ``api/daemon.py``).
``core/``, ``api/``, ``simmpi/`` and ``linalg/`` hold verbatim copies of
the JAX package's NumPy-only modules, the simulator (``SimBackend``) among
them.
"""
