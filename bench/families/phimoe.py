"""``model_type`` phimoe: the decoder family (``decoder.py``), its FFN a
mixture of experts."""

from bench.families.decoder import (  # noqa: F401
    BUILT, READ, arch_config, cost, layout, reference, spec)
