"""The benchmark's harness: one run of one cell.

BENCHMARK.json names the cell's configuration (configs/<config>.json),
its traffic mix (traffic/<traffic>.json, whose "entry" names the driver
drivers/<entry>.py) and its metrics; limits/<cell>.json holds the limit
of each number that `correct` compares. Each metric is read by
metrics/<name>.py (`read(run) -> float | None`), so a cell, a traffic
mix, a configuration or a metric is added by adding files.

A driver module has
    setup(ctx) -> state            inputs, program, warm-up (set-up time)
    window(state, seconds, trace)  the measured window; fills the Run
    judge(state) -> [check]        frees the program's device state, then
                                   the reference comparison
where a check is {"name", "value"} and passes when value <= its
limit. The run's record (`Run`) is what the metric readers read.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from importlib import import_module, util
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pose6d_tpu")


@dataclass
class Run:
    """What one run measured; the metric readers read it."""
    cell: str
    config: dict
    traffic: dict
    seed: int
    trace: bool
    setup_s: float = math.nan
    window_s: float = math.nan
    done: list = field(default_factory=list)      # per batch / step: items
    walls_s: list = field(default_factory=list)   # per batch / step: wall
    spans: dict = field(default_factory=dict)     # span name -> [ms, ...]
    counters: dict = field(default_factory=dict)
    trace_info: dict = field(default_factory=dict)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the port must not load
    (whole names: pose6d_tpu_torch is not pose6d_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell's BENCHMARK.json entries, configuration, traffic, limits
    and the metrics it reports ({"end_to_end": [...], "per_layer":
    [...]})."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads(
        (HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in reported
                              else [])]
    return {"cell": cell, "config": config, "traffic": traffic,
            "limits": limits, "end_to_end": e2e, "per_layer": layer,
            "run_seconds": bench["run_seconds"]}


def reader(metric: str):
    """metrics/<metric>.py's read function."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    mod = util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(run: Run, metrics: list) -> dict:
    """{name: {"value", "unit"}} of the metrics whose reader finds
    something to read."""
    out = {}
    for m in metrics:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def judged(checks: list) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t0: float, device: str = "cuda", overrides: dict | None = None,
             root: Path = ROOT) -> dict:
    """One run; returns the result line's object. `device` and
    `overrides` (traffic keys) are for the CPU tests, which drive every
    step but the look for a card."""
    import torch
    spec = load_cell(name, root)
    traffic = dict(spec["traffic"], **(overrides or {}))
    run = Run(cell=name, config=spec["config"], traffic=traffic, seed=seed,
              trace=trace)
    driver = import_module(f"benchmark.drivers.{traffic['entry']}")
    chips = spec["cell"]["chips"]
    if device == "cuda":
        seen = (torch.cuda.device_count() if torch.cuda.is_available()
                else 0)
        if seen < chips:
            raise SystemExit(f"this cell needs {chips} CUDA device(s); "
                             f"torch sees {seen}")
        kind = torch.cuda.get_device_name(0)
    else:
        kind = "cpu"
    state = driver.setup({"run": run, "device": device, "root": root})
    run.setup_s = time.perf_counter() - t0
    if device == "cuda":       # printed once the program has loaded
        print(json.dumps({"card": kind, "count": chips,
                          "nvidia_smi": card_line()}), flush=True)
    print(json.dumps({"setup_s": run.setup_s,
                      **run.counters.get("setup_phases", {})}), flush=True)
    driver.window(state, seconds, trace)
    peak = (torch.cuda.max_memory_allocated() if device == "cuda" else 0)
    walls = sorted(run.walls_s)
    print(json.dumps({"window_s": run.window_s, "items": len(walls),
                      "wall_ms_p10_p50_p90": [
                          1e3 * walls[int(q * (len(walls) - 1))]
                          for q in (0.1, 0.5, 0.9)]}), flush=True)
    print(json.dumps({"launches": run.counters.get("launches_per_item")}),
          flush=True)
    checks = [dict(c, limit=spec["limits"][c["name"]])
              for c in driver.judge(state)]
    metrics = read_metrics(run, spec["per_layer"] if trace
                           else spec["end_to_end"])
    dev = {"platform": "gpu" if device == "cuda" else "cpu", "kind": kind,
           "count": chips, "memory_peak_bytes": int(peak)}
    if trace:
        dev.update(busy_s=run.trace_info.get("busy_s", 0.0),
                   window_s=run.trace_info.get("window_s", 0.0))
    result = {"correct": judged(checks), "attempted": sum(run.done),
              "failed": int(run.counters.get("failed", 0)),
              "metrics": metrics, "device": dev}
    if trace and "breakdown" in run.trace_info:
        result["breakdown"] = run.trace_info["breakdown"]
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    return result
