"""One run of one cell of the benchmark of feedback_gnn_tpu_torch.

    python3 -m benchmark.run --workload n1270_nG5.mc_p05 --seed 7 --seconds 10 --trace 0

Reads the cell from BENCHMARK.json, its configuration from the file the
manifest names, its traffic from ``benchmark/traffic/<traffic>.json`` and
its limits from ``benchmark/limits/<workload>.json``.  The traffic's
``kind`` names the module that runs it, ``benchmark/<kind>.py``, which
declares ``KIND = "<kind>"`` and defines ``run(r: Run) -> Outcome``: it
sets up, warms up, measures for ``--seconds`` and checks what the timed
path produced against the reference.  The run prints one JSON line last on
standard output.  With ``--trace 0`` the line holds the cell's end-to-end
metrics; with ``--trace 1`` a profiler records a few steps of the window
and each per-layer metric is read from them by its reader,
``benchmark/metrics/<metric>.py``.  Each compared number is printed beside
its limit as the last lines on standard error and under ``checks``, the
line's last key.

It exits with 2 and prints no result where the traffic's kind is not such
a module or no card (or fewer cards than the cell asks for) is found, and
with 3 where JAX or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from .harness import ROOT, Run, load_json, power_limit_w  # noqa: E402

__all__ = ["load_run", "run_cell", "main", "forbidden_modules", "metric_applies", "read_metric", "find_kind",
           "UnknownKind"]

FORBIDDEN = ("jax", "jaxlib", "flax", "feedback_gnn_tpu")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")  # the manifest's rule for a name


class UnknownKind(ValueError):
    """A traffic kind with no module that declares it."""


def find_kind(kind):
    """The module ``benchmark.<kind>`` of a traffic kind, which declares
    ``KIND = "<kind>"`` and defines ``run(r: Run) -> Outcome``; raises
    UnknownKind for any other name, so that no other module of the
    benchmark (``harness``, ``trace``, ...) or a misspelt name runs."""
    if not isinstance(kind, str) or not NAME.match(kind):
        raise UnknownKind(f"traffic kind {kind!r} is not a name")
    name = f"benchmark.{kind}"
    try:
        mod = importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name is None or not (name == e.name or name.startswith(e.name + ".")):
            raise  # the kind's module exists and lacks a module it imports
        mod = None
    if mod is None or getattr(mod, "KIND", None) != kind or not callable(getattr(mod, "run", None)):
        raise UnknownKind(f"no traffic kind {kind!r}: benchmark/{kind}.py has to declare KIND = {kind!r} "
                          "and define run(r)")
    return mod


def forbidden_modules(names=None):
    """Loaded modules whose top-level name (before the first dot), taken
    whole, is JAX's, Flax's or the JAX package's."""
    names = sys.modules if names is None else names
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def metric_applies(metric: dict, cell: str) -> bool:
    return cell in metric["workloads"] if "workloads" in metric else True


def read_metric(name: str, trace, context: dict):
    """The value of a per-layer metric from its reader, or None."""
    path = os.path.join(ROOT, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(trace, context)


def load_run(workload: str, seed: int, seconds: float, trace: bool, device="cuda", batch=None, control=None,
             t_start=None, manifest=None) -> Run:
    """The Run of one cell: its entry, configuration, traffic and limits,
    found by name; ``batch`` and ``control`` are for the CPU tests and
    calibration only."""
    manifest = manifest or load_json("BENCHMARK.json")
    cell = next((w for w in manifest["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    return Run(cell=cell, config=load_json(conf["file"]),
               traffic=load_json(os.path.join("benchmark", "traffic", f"{cell['traffic']}.json")),
               limits=load_json(os.path.join("benchmark", "limits", f"{workload}.json")), seed=int(seed),
               seconds=float(seconds), trace=bool(trace), device=torch.device(device),
               t_start=T_START if t_start is None else t_start, control=control, batch=batch)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda", batch=None,
             control=None, t_start=None, manifest=None):
    """(result line as a dict, Outcome) of one run."""
    manifest = manifest or load_json("BENCHMARK.json")
    r = load_run(workload, seed, seconds, trace, device, batch, control, t_start, manifest)
    cell = r.cell
    out = find_kind(r.traffic["kind"]).run(r)

    dev = r.device
    metrics = {}
    if trace:
        for m in manifest["per_layer"]:
            if metric_applies(m, workload) and out.trace is not None:
                v = read_metric(m["name"], out.trace, out.context)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in manifest["end_to_end"]:
            if metric_applies(m, workload) and m["name"] in out.metrics:
                metrics[m["name"]] = {"value": out.metrics[m["name"]], "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": int(cell["chips"]),
        "memory_peak_bytes": out.memory_peak_bytes,
    }
    result = {"correct": out.correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": device_info}
    if trace and out.trace is not None:
        device_info["busy_s"] = out.trace.busy_s
        device_info["window_s"] = out.trace.window_s
        result["breakdown"] = out.trace.breakdown()
    if dev.type == "cuda":
        result["power_limit_w"] = power_limit_w()
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in out.checks}
    return result, out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    manifest = load_json("BENCHMARK.json")
    cell = next((w for w in manifest["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    try:
        find_kind(load_json(os.path.join("benchmark", "traffic", f"{cell['traffic']}.json"))["kind"])
    except UnknownKind as e:
        print(e, file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result, out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), manifest=manifest)
    bad = forbidden_modules()
    if bad:
        print(f"JAX or the JAX package was loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for line in out.notes:
        print(f"# {line}", file=sys.stderr)
    if result.get("power_limit_w") is not None:
        print(f"# {result['device']['kind']}, power limit {result['power_limit_w']} W", file=sys.stderr)
    for name, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
