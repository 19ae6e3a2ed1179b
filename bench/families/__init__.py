"""A model family: what the benchmark knows of an architecture, in a file of
its own.  A configuration's ``model_type`` names the file
``bench/families/<model_type>.py`` under the checkout's root, loaded by
path as ``bench/harness/metrics.py`` loads a metric's reader; a
``model_type`` with no file is not built.  A new family is a new file, and
nothing else of the benchmark changes.  The file provides:

- ``READ``: the configuration keys it reads, beyond the shared ones
  (``bench/spec.py`` ``RECORD`` and the ``run`` knobs ``RUN``); ``BUILT``
  (optional): {key: the values it builds}.  A key that neither the shared
  sets nor the family reads, or a value it does not build, is refused.
- ``spec(cfg)``: the run's spec from the configuration file's contents, a
  frozen dataclass with at least the fields the shared harness reads:
  ``name``, ``model_type``, ``n_layers``, ``d_model``, ``vocab``,
  ``tie_embeddings``, the dtypes (``param_dtype``, ``compute_dtype``,
  ``logits_dtype``), the init stds (``norm_init_std``,
  ``embed_init_std``, ``residual_init_scale``), and ``family``, which
  ``bench/spec.py`` ``model_spec`` fills with the family's module.
- ``arch_config(spec)``: the program's ``ArchConfig`` (imported inside the
  function: a family file imports nothing of the program).
- ``layout(spec)``: {group: {name: (shape, std)}} of every parameter, in
  the program's layout; ``bench/harness/weights.py`` draws each from the
  seed by its ``group/name``.
- ``reference``: a module of plain PyTorch, importing nothing of the
  program, with ``hidden``, ``loss(params, batch, spec, prec)``,
  ``logits_at(params, tokens, spec, rows, groups, prec)``, the serve
  check's ``candidates(params, tokens, spec, rows, groups, prec)`` (per
  row, the logits under each answer the stated model allows, such as the
  routings of a near tie) and ``check_slots(spec, slots)`` (refuses a
  serving cell whose decode step the per-request check cannot reproduce).
- ``cost``: a module with the counts ``bench/cost/model.py`` passes each
  call to: ``layer_forward``, ``head``, ``train_matmul``, ``train_flash``,
  ``active_layer_params``, ``attention_flops``, ``train_model_flops``,
  ``prefill_matmul``, ``prefill_flash``, ``prefill_model_flops``,
  ``decode_matmul`` and ``decode_model_flops``.
"""

from __future__ import annotations

import importlib.util
import re
import sys
from pathlib import Path


def load(model_type, root: Path):
    """The family module of ``model_type`` under ``root``; raises
    ``ValueError`` where there is none."""
    where = f"bench/families/{model_type}.py"
    if not (isinstance(model_type, str)
            and re.fullmatch(r"[A-Za-z0-9_]+", model_type)
            and (root / where).is_file()):
        raise ValueError(f"model_type {model_type!r} is not built: no "
                         f"{where}")
    name = f"bench.families.{model_type}"
    spec = importlib.util.spec_from_file_location(name, root / where)
    mod = importlib.util.module_from_spec(spec)
    # registered before it runs, as an import would be, so that the file
    # may name itself (``sys.modules[__name__]``) and define dataclasses
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod
