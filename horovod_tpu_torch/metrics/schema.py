"""Minimal JSON-schema validation for metrics snapshots: the port's own
copy of ``horovod_tpu.metrics.schema``.

A snapshot is checked against the repository's schema
(docs/metrics_schema.json), which holds one sub-schema per snapshot kind,
so the exposition format cannot drift silently. The validator implements
only the subset the schema uses (``type``, ``required``, ``properties``,
``additionalProperties``, ``items``, ``enum``, ``minimum``), so no
``jsonschema`` package is needed.
"""

from __future__ import annotations

import json
import os
from typing import Any, List

_TYPES = {
    "object": dict,
    "array": list,
    "string": str,
    "number": (int, float),
    "integer": int,
    "boolean": bool,
    "null": type(None),
}

SCHEMA_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "docs",
    "metrics_schema.json")


def load_schema(path: str = "") -> dict:
    with open(path or SCHEMA_PATH) as f:
        return json.load(f)


def validate(obj: Any, schema: dict, path: str = "$") -> List[str]:
    """Return a list of human-readable violations (empty = valid)."""
    errs: List[str] = []
    t = schema.get("type")
    if t is not None:
        types = t if isinstance(t, list) else [t]
        py = tuple(_TYPES[x] for x in types)
        ok = isinstance(obj, py)
        # bool is an int subclass; don't let True satisfy "integer"/"number"
        if isinstance(obj, bool) and "boolean" not in types:
            ok = False
        if not ok:
            return [f"{path}: expected {t}, got {type(obj).__name__}"]
    if "enum" in schema and obj not in schema["enum"]:
        errs.append(f"{path}: {obj!r} not in {schema['enum']}")
    if "minimum" in schema and isinstance(obj, (int, float)) \
            and not isinstance(obj, bool) and obj < schema["minimum"]:
        errs.append(f"{path}: {obj} < minimum {schema['minimum']}")
    if isinstance(obj, dict):
        for req in schema.get("required", []):
            if req not in obj:
                errs.append(f"{path}: missing required key {req!r}")
        props = schema.get("properties", {})
        for k, v in obj.items():
            if k in props:
                errs.extend(validate(v, props[k], f"{path}.{k}"))
            else:
                extra = schema.get("additionalProperties")
                if extra is False:
                    errs.append(f"{path}: unexpected key {k!r}")
                elif isinstance(extra, dict):
                    errs.extend(validate(v, extra, f"{path}.{k}"))
    if isinstance(obj, list) and "items" in schema:
        for i, v in enumerate(obj):
            errs.extend(validate(v, schema["items"], f"{path}[{i}]"))
    return errs


def validate_snapshot(snapshot: dict, schema_path: str = "") -> List[str]:
    """Validate a per-rank or pod snapshot against the checked-in schema
    (docs/metrics_schema.json holds one sub-schema per snapshot kind,
    selected by the snapshot's own ``schema`` tag)."""
    doc = load_schema(schema_path)
    kind = "pod" if str(snapshot.get("schema", "")).endswith("pod.v1") \
        else "rank"
    return validate(snapshot, doc[kind])
