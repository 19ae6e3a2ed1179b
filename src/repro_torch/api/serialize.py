"""Lossless JSON encoding for study artifacts.

Study results carry values JSON cannot represent natively — tuples inside
``ConfigRecord.params`` (signature dims, grid shapes), NumPy scalars from
vectorized reductions, and infinities from unbounded CIs.  ``to_jsonable``
/ ``from_jsonable`` give them a tagged, round-trip-exact encoding shared
by session checkpoints, ``StudyResult.to_json`` and the
``benchmarks/results/`` writers:

- tuples   -> {"__tuple__": [...]}            (lists stay lists)
- inf/nan  -> {"__float__": "inf"|"-inf"|"nan"}
- np ints/floats/bools -> their Python equivalents (value-lossless)

Everything else must already be JSON-native; unknown objects raise rather
than silently degrading to ``str``.
"""

from __future__ import annotations

import json
import math
from typing import Any

import numpy as np

_FLOAT_TAGS = {"inf": math.inf, "-inf": -math.inf, "nan": math.nan}


def dumps_canonical(v: Any) -> str:
    """One canonical JSON string per value: tagged encoding, sorted keys.
    This is the identity form shared by session checkpoint keys and
    statistics-bank fingerprints — two values compare equal iff their
    canonical strings do.  The separators are json.dumps's defaults ON
    PURPOSE: for JSON-native values this reproduces the historical
    ``json.dumps(key, sort_keys=True)`` checkpoint-key format byte for
    byte, so journals written before this helper existed keep
    resolving."""
    return json.dumps(to_jsonable(v), sort_keys=True)


def to_jsonable(v: Any) -> Any:
    if isinstance(v, bool) or v is None or isinstance(v, str):
        return v
    if isinstance(v, (np.bool_,)):
        return bool(v)
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, (float, np.floating)):
        v = float(v)
        if math.isinf(v):
            return {"__float__": "inf" if v > 0 else "-inf"}
        if math.isnan(v):
            return {"__float__": "nan"}
        return v
    if isinstance(v, tuple):
        return {"__tuple__": [to_jsonable(x) for x in v]}
    if isinstance(v, (list, np.ndarray)):
        return [to_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): to_jsonable(x) for k, x in v.items()}
    raise TypeError(f"cannot serialize {type(v).__name__}: {v!r}")


def from_jsonable(v: Any) -> Any:
    if isinstance(v, dict):
        if "__tuple__" in v and len(v) == 1:
            return tuple(from_jsonable(x) for x in v["__tuple__"])
        if "__float__" in v and len(v) == 1:
            return _FLOAT_TAGS[v["__float__"]]
        return {k: from_jsonable(x) for k, x in v.items()}
    if isinstance(v, list):
        return [from_jsonable(x) for x in v]
    return v
