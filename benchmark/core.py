"""What every cell shares: finding a cell's files by name, the program's
run config, the device's description, spans, the per-layer readers, the
import check and the result line.

A cell is an entry of BENCHMARK.json's `workloads`; its configuration is
benchmark/configs/<config>.json, its traffic benchmark/traffic/<traffic>.json
(whose `entry` names the driver, benchmark/entries/<entry>.py), its limits
benchmark/cells/<cell>.json, and each per-layer metric's reader
benchmark/metrics/<metric>.py. Adding any of them is adding files and
entries.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

BENCH = "benchmark"
# Top-level module names no run may load: JAX, and the JAX package the
# program is ported from (dssm_tpu_torch is another name).
FORBIDDEN = ("jax", "jaxlib", "flax", "dssm_tpu")


def load_json(root: str, *parts: str) -> Any:
    with open(os.path.join(root, *parts)) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of the manifest with the files it names."""
    root: str
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    manifest: Dict

    def end_to_end(self) -> List[Dict]:
        return [m for m in self.manifest["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> List[Dict]:
        """The per-layer metrics this cell reports: those listing it, and
        those without a list whose moved metric it reports."""
        mine = {m["name"] for m in self.end_to_end()}
        return [m for m in self.manifest["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in mine)]


def load_cell(root: str, name: str) -> Cell:
    manifest = load_json(root, "BENCHMARK.json")
    found = [w for w in manifest["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    return Cell(root=root, name=name, chips=int(w["chips"]),
                config=load_json(root, BENCH, "configs",
                                 f"{w['config']}.json"),
                traffic=load_json(root, BENCH, "traffic",
                                  f"{w['traffic']}.json"),
                limits=load_json(root, BENCH, "cells",
                                 f"{name}.json")["limits"],
                manifest=manifest)


def run_config(cell: Cell):
    """The program's RunConfig: the configuration's preset with every
    setting of the configuration and then of the traffic applied, checked
    by the program's own validation."""
    from dssm_tpu_torch.config import apply_overrides, get_preset, validate

    settings = {**cell.config["settings"], **cell.traffic.get("settings", {})}
    cfg = apply_overrides(get_preset(cell.config["preset"]), {
        k: tuple(v) if isinstance(v, list) else v
        for k, v in settings.items()})
    return validate(cfg)


def tower_of(cfg) -> Dict:
    """The tower's sizes as the reference takes them."""
    t = cfg.tower
    return {"arch": t.arch, "vocab_size": t.vocab_size,
            "embed_width": t.embed_width,
            "hidden_dims": list(t.hidden_dims),
            "semantic_dim": t.semantic_dim, "activation": t.activation}


def entry(cell: Cell):
    return importlib.import_module(f"{BENCH}.entries.{cell.traffic['entry']}")


def reader(root: str, metric: str) -> Callable:
    """benchmark/metrics/<metric>.py's read(stretch)."""
    path = os.path.join(root, BENCH, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"{BENCH}.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Spans:
    """Host-clock spans the benchmark records around its calls into the
    program: {name: [seconds, ...]}."""

    def __init__(self):
        self.spans: Dict[str, List[float]] = {}

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.setdefault(name, []).append(time.perf_counter() - t0)


@dataclass
class Stretch:
    """What the per-layer readers read: the profiled stretch (its units,
    the trace, the work its units needed) and an unprofiled stretch of the
    same run (its units, wall seconds and spans)."""
    kind: str                       # the traffic's entry: train, eval, serve
    units: int = 0                  # steps, passes or requests profiled
    busy_s: float = 0.0
    window_s: float = 0.0
    work: List = field(default_factory=list)   # work.counts.Item, profiled
    unit_flops: float = 0.0         # mean model FLOPs a unit
    wall_units: int = 0
    wall_s: float = 0.0
    spans: Dict[str, List[float]] = field(default_factory=dict)


def device_info(chips: int, device) -> Dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=20)
        info["power_limit_w"] = float(out.stdout.strip())
    except (OSError, ValueError, subprocess.SubprocessError):
        info["power_limit_w"] = None
    return info


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, Dict], device: Dict,
                checks: Dict[str, Dict], breakdown: Optional[Dict] = None
                ) -> str:
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks  # last: each compared number beside its limit
    return json.dumps(out)
