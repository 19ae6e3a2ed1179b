"""``model_type`` llama: the decoder family (``decoder.py``), its FFN
dense."""

from bench.families.decoder import (  # noqa: F401
    BUILT, READ, arch_config, cost, layout, reference, spec)
