"""Every metric is read by a small file of its own,
``bench/metrics/<name>.py``, found by the name ``BENCHMARK.json`` gives
it.  Its ``read(run)`` takes the run's record (``Run``) and returns the
number, or None where it finds nothing to read; the run's line then
leaves the metric out.
"""

from __future__ import annotations

import importlib.util
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

from .trace import TraceStats


@dataclass
class Run:
    """What a run saw.  ``device``: the device type it measured on
    (readers of device numbers read nothing but ``"cuda"``).  ``window``:
    the measured window's record (seconds, steps, tokens, launches; a
    serve run's prefills, decode steps and latencies).  ``traced``: the
    work of the traced stretch (a train run's ``steps``; a serve run's
    ``prefills`` (prompt lengths) and ``decode_rows``).  ``trace``: the
    traced stretch's reduction, None without one."""

    kind: str
    device: str
    spec: object        # the cell's spec (its family's)
    traffic: dict
    setup_s: float
    window: Dict[str, object] = field(default_factory=dict)
    traced: Dict[str, object] = field(default_factory=dict)
    trace: Optional[TraceStats] = None


def reader(name: str, root: Path):
    path = root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_all(entries: List[dict], run: Run, root: Path) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of the metric entries that found
    something."""
    out = {}
    for m in entries:
        v = reader(m["name"], root)(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
