"""Run one cell of the benchmark once and print its result line.

    python3 -m sdrbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA cards.
The cell (`workloads` in BENCHMARK.json) names a configuration, whose
file lies under `sdrbench/configs/`, and a traffic mix,
`sdrbench/traffic/<traffic>.json`, which names its driver,
`sdrbench/drivers/<driver>.py`. Per-layer metrics are read by
`sdrbench/metrics/<metric>.py` and kernel rooflines counted by
`sdrbench/roofline/<kernel>.py`; the limits of the comparison that
decides `correct` are `sdrbench/limits/<cell>.json`. Everything is found
by name, so a new cell, mix, driver or metric is a new file.

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones), `device`, with `--trace 1` a
`breakdown`, and last `compared`, each compared number beside its limit,
which also end standard error. The run exits non-zero and prints no
result without the cards the cell asks for, or when a module of JAX or of
the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
# kernel caches at fixed paths inside the checkout (the port's own nvcc
# build lands in supersdr_tpu_torch/build/, also inside it)
CACHE = ROOT / ".sdrbench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")

FORBIDDEN = ("jax", "jaxlib", "flax", "supersdr_tpu")
GIB = float(1 << 30)


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_spec() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(spec: dict, name: str) -> tuple[dict, dict, dict]:
    """(workload, configuration file, traffic file) of a cell."""
    wl = next((w for w in spec["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in spec["configs"] if c["name"] == wl["config"])
    with open(ROOT / entry["file"]) as f:
        conf = json.load(f)
    with open(BENCH / "traffic" / f"{wl['traffic']}.json") as f:
        traffic = json.load(f)
    return wl, conf, traffic


def metric_reader(name: str):
    """`read(ctx)` of sdrbench/metrics/<name>.py (names may hold dots)."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"sdrbench.metrics.{name.replace('.', '__')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def e2e_value(e2e: dict, name: str) -> float:
    """The driver's reading of an end-to-end metric. `<quantity>.<cells>`
    is the driver's `<quantity>` under a bound of its own, in the cells
    it lists."""
    return e2e[name] if name in e2e else e2e[name.split(".")[0]]


def applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


class Cell:
    """One run of one cell: what the driver reads, the limits that decide
    `correct`, and the set-up, memory and clock bookkeeping around its
    window."""

    def __init__(self, name, conf, traffic, seed, seconds, trace, device,
                 limits):
        self.name, self.conf, self.traffic = name, conf, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.limits = device, limits
        self.setup_s = None
        self._setup_peak = 0

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            import torch
            torch.cuda.synchronize(self.device)

    def opened(self) -> None:
        """Set-up is over: its time, and the window's memory peak from
        here. The garbage collector rests until the window closes, so no
        collection pauses a chunk."""
        self.sync()
        gc.collect()
        gc.freeze()
        gc.disable()
        self.setup_s = time.perf_counter() - T_START
        if self.cuda:
            import torch
            self._setup_peak = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)

    def closed(self) -> dict:
        """The window is over: the memory it peaked at (read before the
        reference runs)."""
        self.sync()
        gc.enable()
        peak = 0
        if self.cuda:
            import torch
            peak = torch.cuda.max_memory_allocated(self.device)
        return {"memory_peak_bytes": max(peak, self._setup_peak),
                "e2e": {"setup_s": self.setup_s, "peak_mem_gib": peak / GIB}}

    def free(self) -> None:
        gc.collect()
        if self.cuda:
            import torch
            torch.cuda.empty_cache()


def pin_to_one_core() -> None:
    """Run the process, and the threads the CUDA runtime starts later, on
    one core, with one intra-op thread: on a host shared with other work
    the host-bound cells spread less from run to run."""
    os.sched_setaffinity(0, {min(os.sched_getaffinity(0))})
    import torch
    torch.set_num_threads(1)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def execute(cell: Cell, make_system, spec: dict) -> tuple[dict, list[str]]:
    """Run the cell's driver on the system `make_system(conf, frames,
    device)` builds and make the result line; returns (result, lines for
    standard error)."""
    from sdrbench import trace as tr_mod
    driver = importlib.import_module(
        f"sdrbench.drivers.{cell.traffic['driver']}")
    res = driver.run(cell, make_system)
    ok, compared = res["readings"].verdict(cell.limits)
    lines = list(res.get("notes", []))
    if not res.get("launches_ok", True):
        lines.append("not correct: the timed chunks did not launch each "
                     "counted kernel as often as the configuration says")
    correct = ok and res.get("launches_ok", True)
    if cell.trace:
        trace = res.get("trace")
        ctx = {"trace": trace, "conf": cell.conf,
               "frames": cell.traffic["frames"],
               "dispatch_ms": res.get("dispatch_ms")}
        metrics = {}
        for m in spec["per_layer"]:
            if applies(m, cell.name):
                v = metric_reader(m["name"])(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e_value(res["e2e"], m["name"]),
                               "unit": m["unit"]}
                   for m in spec["end_to_end"] if applies(m, cell.name)}
    device = {"platform": "gpu" if cell.cuda else cell.device.type,
              "kind": "cpu", "count": 1,
              "memory_peak_bytes": res["memory_peak_bytes"]}
    if cell.cuda:
        import torch
        device["kind"] = torch.cuda.get_device_name(cell.device)
        device["power"] = power_limit()
        lines.append(f"card: {device['power']}")
    result = {"correct": bool(correct), "attempted": res["attempted"],
              "failed": res["failed"], "metrics": metrics, "device": device}
    if cell.trace and res.get("trace") is not None:
        trace = res["trace"]
        device["busy_s"] = tr_mod.busy_s(trace)
        device["window_s"] = trace.window_s
        result["breakdown"] = tr_mod.breakdown(trace)
    result["compared"] = compared
    lines += [f"compared {n}: {v} limit {lim}"
              for n, (v, lim) in compared.items()]
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--system", choices=("program", "control"),
                    default="program",
                    help="control: the reference at the precision below "
                         "the configuration's, in the program's place")
    args = ap.parse_args(argv)
    pin_to_one_core()
    spec = load_spec()
    wl, conf, traffic = find_cell(spec, args.workload)
    from sdrbench import check
    limits = check.load_limits(wl["name"])
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print(f"sdrbench: {wl['name']} needs {wl['chips']} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cell = Cell(wl["name"], conf, traffic, args.seed, args.seconds,
                bool(args.trace), device, limits)
    from sdrbench.system import SYSTEMS
    result, lines = execute(cell, SYSTEMS[args.system], spec)
    bad = forbidden_modules()
    if bad:
        print(f"sdrbench: loaded {bad}: the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
