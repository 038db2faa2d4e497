"""Layered engine options (the reference's option sets, the ~100 knobs of
assemble_options, modules/variants/assemble.h:475, and its product files,
etc/products/*.json).

Counterpart of ``biograph_tpu/runtime/config.py`` without its environment
layers: the port reads no environment switches, so a product file is a
dict the caller passes and the CLI's ``--opt field=value`` comes last:

  defaults (the dataclass's field defaults)
    < product (a flat key -> value dict)
    < CLI     (--opt field=value, repeatable)

``apply_options(opt, overrides, product)`` resolves the layers onto any
options dataclass (``DiscoverOptions``, ``SvOptions``, ...), coercing each
value by the type of the field's current value."""

from __future__ import annotations

import dataclasses
from typing import Dict, List


def _coerce(value: str, like):
    if isinstance(like, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(like, int):
        return int(value)
    if isinstance(like, float):
        return float(value)
    if isinstance(like, tuple):  # e.g. trace_offsets=1234,5678
        return tuple(int(x) for x in value.split(",") if x.strip())
    return value


def apply_options(opt, cli_overrides: List[str] | None = None, product: Dict | None = None):
    """Resolve layered overrides onto an options dataclass, in place.

    product: a flat {field: value} dict (values as strings or as values);
    keys that are not fields of ``opt`` are skipped, since one product file
    serves several option sets.  cli_overrides: ["field=value", ...];
    unknown fields raise (a typo must not silently do nothing).  Returns
    {field: (value, source)} of what was applied."""
    fields = {f.name for f in dataclasses.fields(opt)}
    applied = {}

    def set_one(name: str, raw: str, source: str):
        if name not in fields:
            raise ValueError(f"unknown option {name!r} for {type(opt).__name__} (have: {', '.join(sorted(fields))})")
        val = _coerce(raw, getattr(opt, name))
        setattr(opt, name, val)
        applied[name] = (val, source)

    for k, v in (product or {}).items():
        if str(k) in fields:
            set_one(str(k), str(v), "product")
    for item in cli_overrides or []:
        if "=" not in item:
            raise ValueError(f"--opt needs field=value, got {item!r}")
        name, raw = item.split("=", 1)
        set_one(name.strip(), raw, "cli")
    return applied
