"""``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix, per-layer metric
or cell is a file of its own, found by the name that ``BENCHMARK.json``
gives it: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py`` (a ``read(ctx)`` function), ``limits/<cell>.json``
(the limits of the correctness comparison) and, named inside the
configuration, ``drivers/<driver>.py`` (how the program under test is built
and run, and its reference). Adding a configuration, a mix or a metric adds
files and entries and edits none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


class Spec:
    def __init__(self, path: Optional[str] = None, here: str = HERE):
        self.path = path or os.path.join(ROOT, "BENCHMARK.json")
        with open(self.path) as f:
            self.doc = json.load(f)
        bad = check_names(self.doc)
        if bad:
            raise ValueError(f"{self.path}: malformed " + "; ".join(bad))
        self.here = here
        self.configs = {c["name"]: c for c in self.doc["configs"]}
        self.cells = {w["name"]: w for w in self.doc["workloads"]}

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in {self.path}; have {sorted(self.cells)}")
        return self.cells[name]

    def _json(self, *parts) -> dict:
        with open(os.path.join(self.here, *parts)) as f:
            return json.load(f)

    def config(self, cell: dict) -> dict:
        return self._json("configs", f"{cell['config']}.json")

    def traffic(self, cell: dict) -> dict:
        return self._json("traffic", f"{cell['traffic']}.json")

    def limits(self, cell: dict) -> Dict[str, float]:
        return self._json("limits", f"{cell['name']}.json")

    def driver(self, config: dict):
        return importlib.import_module(f"gnnbench.drivers.{config['driver']}")

    def metrics(self, kind: str, cell: dict) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports."""
        return [m for m in self.doc[kind]
                if "workloads" not in m or cell["name"] in m["workloads"]]

    def reader(self, metric: dict):
        """The ``read`` function of ``metrics/<name>.py``."""
        path = os.path.join(self.here, "metrics", f"{metric['name']}.py")
        spec = importlib.util.spec_from_file_location(f"gnnbench_metric_{metric['name']}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def check_names(doc: dict) -> List[str]:
    """What in ``doc`` breaks the rules for names and units."""
    bad = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in doc.get(kind, []):
            for key in ("name", "config", "traffic"):
                if key in entry and not NAME.fullmatch(str(entry[key])):
                    bad.append(f"{kind} {key} {entry[key]!r}")
            for key in entry.get("reduced", []):
                if not NAME.fullmatch(key):
                    bad.append(f"{kind} reduced {key!r}")
            if "unit" in entry and not UNIT.fullmatch(entry["unit"]):
                bad.append(f"{kind} unit {entry['unit']!r}")
    return bad
