"""Command-line flags shared by the port's entry points.

    --preset=NAME  --cpu  --resume  --section.field=value ...

Any config field is overridable with --section.field=value (types coerced
from the preset's current values). A copy of dssm_tpu/cli/train.py's
parse_argv and coerce_overrides.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from dssm_tpu_torch.config import RunConfig, apply_overrides


def parse_argv(argv: List[str]) -> Tuple[str, bool, bool, Dict[str, str]]:
    preset, cpu, resume = "tiny", False, False
    overrides: Dict[str, str] = {}
    for arg in argv:
        if not arg.startswith("--"):
            raise SystemExit(f"unexpected argument {arg!r}; use --key=value")
        body = arg[2:]
        if body == "cpu":
            cpu = True
        elif body == "resume":
            resume = True
        elif body.startswith("preset="):
            preset = body.split("=", 1)[1]
        elif "=" in body:
            k, v = body.split("=", 1)
            overrides[k] = v
        else:
            raise SystemExit(f"unknown flag {arg!r}")
    return preset, cpu, resume, overrides


def coerce_overrides(cfg: RunConfig, overrides: Dict[str, str]) -> RunConfig:
    """Coerce string values to each field's current type, then apply."""
    typed = {}
    for key, raw in overrides.items():
        node = cfg
        for part in key.split("."):
            node = getattr(node, part)  # raises AttributeError for bad keys
        if isinstance(node, bool):
            typed[key] = raw.lower() in ("1", "true", "yes")
        elif isinstance(node, int):
            typed[key] = int(raw)
        elif isinstance(node, float):
            typed[key] = float(raw)
        elif isinstance(node, tuple):
            typed[key] = tuple(int(x) for x in raw.split(",") if x)
        else:
            typed[key] = raw
    return apply_overrides(cfg, typed)
