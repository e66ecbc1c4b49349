"""Versioned JSON result artifacts written under ``experiments/torch/eval/``.

One artifact per suite:

    {
      "schema_version": 1,
      "suite": "denoise",
      "config": {"smoke": false, "seed": 0, "torch": "2.x",
                 "device": "NVIDIA H100 80GB HBM3", ...},
      "created": "2026-07-30T12:00:00+00:00",     # informational only
      "tables": {"denoise": [ {row}, ... ], ...}
    }

``tables`` maps table name -> list of flat row dicts (str/int/float/bool/
None values only), so downstream tooling can diff results across PRs
without importing the repo. ``created`` is excluded from equality-style
checks — table rendering (markdown.py) never consumes it.
"""
from __future__ import annotations

import datetime
import json
from pathlib import Path
from typing import Dict, List

SCHEMA_VERSION = 1

_SCALARS = (str, int, float, bool, type(None))


def make_artifact(suite: str, tables: Dict[str, List[Dict]],
                  config: Dict) -> Dict:
    art = {
        "schema_version": SCHEMA_VERSION,
        "suite": suite,
        "config": dict(config),
        "created": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        "tables": tables,
    }
    validate(art)
    return art


def validate(art: Dict) -> None:
    """Raise ValueError unless `art` matches the v1 schema."""
    if not isinstance(art, dict):
        raise ValueError("artifact must be a dict")
    missing = {"schema_version", "suite", "config", "tables"} - set(art)
    if missing:
        raise ValueError(f"artifact missing keys: {sorted(missing)}")
    if art["schema_version"] != SCHEMA_VERSION:
        raise ValueError(f"unsupported schema_version "
                         f"{art['schema_version']!r} (expected "
                         f"{SCHEMA_VERSION})")
    if not isinstance(art["suite"], str) or not art["suite"]:
        raise ValueError("artifact suite must be a non-empty string")
    if not isinstance(art["config"], dict):
        raise ValueError("artifact config must be a dict")
    if not isinstance(art["tables"], dict) or not art["tables"]:
        raise ValueError("artifact tables must be a non-empty dict")
    for tname, rows in art["tables"].items():
        if not isinstance(rows, list):
            raise ValueError(f"table {tname!r} must be a list of rows")
        for i, row in enumerate(rows):
            if not isinstance(row, dict):
                raise ValueError(f"table {tname!r} row {i} is not a dict")
            for k, v in row.items():
                if not isinstance(v, _SCALARS):
                    raise ValueError(
                        f"table {tname!r} row {i} key {k!r} has "
                        f"non-scalar value of type {type(v).__name__}")


def save(path: Path, art: Dict) -> None:
    validate(art)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(art, indent=1, sort_keys=False) + "\n")


def load(path: Path) -> Dict:
    art = json.loads(Path(path).read_text())
    validate(art)
    return art
