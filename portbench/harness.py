"""Find a cell's files by name and run it once.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
harness reads ``configs/<config>.json`` (through the path the entry gives),
``traffic/<traffic>.json``, ``limits/<cell>.json`` and, for each per-layer
metric the cell reports, ``metrics/<metric>.py``. The traffic file's
``loop`` names the module under ``loops/`` that drives the program. So a
later cell, mix or metric is a set of new files and new entries, and no
file here changes.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tuturenderer_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    here: Path = HERE


def load_benchmark(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve_cell(root: Path, name: str, bench: Optional[dict] = None,
                 here: Path = HERE) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files loaded."""
    bench = bench or load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    read = lambda p: json.loads(Path(p).read_text())
    return Cell(name=name, chips=int(w["chips"]),
                config=read(root / conf["file"]),
                traffic=read(here / "traffic" / f"{w['traffic']}.json"),
                limits=read(here / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer, here=here)


def load_loop(cell: Cell):
    return importlib.import_module(f"portbench.loops.{cell.traffic['loop']}")


def load_reader(name: str, here: Path = HERE):
    """``metrics/<name>.py``'s ``read``, loaded by path (a metric's name
    may hold dots)."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def device_info(torch, chips: int, peak_bytes: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak_bytes)}


def judge(checks: Dict[str, float], limits: dict):
    """-> (correct, {name: {value, limit}}): every number at or under its
    limit, and finite."""
    out, ok = {}, True
    for name, value in checks.items():
        limit = limits[name]
        good = value == value and value <= limit
        ok = ok and good
        out[name] = {"value": value, "limit": limit}
    return ok, out


def run_cell(root: Path, name: str, seed: int, seconds: float,
             trace: bool, t_start: float) -> int:
    """One run of a cell on the card; prints the result line last on
    stdout and the compared numbers last on stderr. Returns the exit
    code: 2 without the cards the cell asks for, 3 if JAX or the JAX
    package was loaded; neither prints a result."""
    import torch
    cell = resolve_cell(root, name)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {found}", file=sys.stderr)
        return 2
    line = drive(cell, seed, seconds, trace, torch.device("cuda"), t_start)
    if line is None:
        return 3
    print(json.dumps(line), flush=True)
    return 0


def drive(cell: Cell, seed: int, seconds: float, trace: bool, device,
          t_start: float) -> Optional[dict]:
    """Set-up, the window and the check of one run on ``device`` -> the
    result line, or None (after saying why on stderr) where the run loaded
    JAX or the JAX package."""
    import torch
    loop = load_loop(cell)
    t_imported = time.perf_counter()
    if device.type == "cuda":
        torch.empty(1, device=device)           # the CUDA context
        torch.cuda.synchronize(device)
    t_context = time.perf_counter()
    state = loop.setup(cell, seed, device)
    t_done = time.perf_counter()
    state.info["setup_s"] = t_done - t_start
    build = state.info["table_build_s"]
    print(f"setup: {state.info['setup_s']:.3f} s = imports "
          f"{t_imported - t_start:.3f} + CUDA context "
          f"{t_context - t_imported:.3f} + scene and tables {build:.3f} + "
          f"the rest (the port's import, camera, kernels, warm-up) "
          f"{t_done - t_context - build:.3f}",
          file=sys.stderr)
    digest = None
    if trace:
        from . import tracing
        digest = tracing.capture(loop, state,
                                 int(cell.traffic.get("trace_units", 1)))
    result = loop.window(state, seconds)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; the benchmark "
              "measures the PyTorch port alone", file=sys.stderr)
        return None
    if device.type == "cuda":
        peak = max(torch.cuda.max_memory_allocated(),
                   state.info.get("peak_before_trace", 0))
        dev = device_info(torch, cell.chips, peak)
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 0,
               "memory_peak_bytes": 0}
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = load_reader(m["name"], cell.here)(state, digest)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = digest.busy_s
        dev["window_s"] = digest.window_s
    else:
        values = dict(result["values"], setup_s=state.info["setup_s"])
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    correct, judged = judge(loop.check(state), cell.limits)
    for k, v in judged.items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    line = {"correct": correct, "attempted": result["attempted"],
            "failed": result["failed"], "metrics": metrics, "device": dev}
    if trace:
        line["breakdown"] = digest.breakdown
    line["checks"] = judged
    return line
