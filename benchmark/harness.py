"""What every cell shares: finding the cell's files by name, the run's
context that a driver fills, the checks, and the result line.

A driver (``drivers/<name>.py``) has one function, ``run(cell)``: it sets
the program up, calls ``cell.begin_window()`` when set-up ends, measures
for ``cell.seconds``, reads the device's memory peak with
``cell.read_peak()``, frees the program's state and hands what it kept to
the reference. It returns an ``Outcome``. Per-layer readers
(``layer_metrics/<metric>.py``) each take ``cell.record`` and return a
number or None; metrics of one family (``mfu.audio``, ``mfu.train``) may
share one reader, named by the part before the first dot.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# top-level module names that no run may load: JAX, its libraries and the
# JAX package the port was made from (compared whole: the port's own name
# begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "audiodenoiser_tpu")
CACHE_DIR = ROOT / ".bench_cache"


def pin_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    set before torch is imported. The port's nvcc builds go to its own
    fixed ``audiodenoiser_torch/_build/``."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        path = CACHE_DIR / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is in ``FORBIDDEN``."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN})


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def find_cell(spec: dict, workload: str, root: Path = ROOT) -> dict:
    """The cell's entry with its configuration file, traffic mix and limits,
    from the checkout at ``root``."""
    bench = root / BENCH_DIR.name
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    entry = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    return {"entry": entry,
            "config": load_json(root / configs[entry["config"]]["file"]),
            "traffic": load_json(bench / "traffic" / f"{entry['traffic']}.json"),
            "limits": load_json(bench / "limits" / f"{workload}.json")}


def applies(metric: dict, cell_name: str, reported: set) -> bool:
    """Whether ``metric`` belongs in this cell's line: listed for it, or,
    without a ``workloads`` key, in every cell (end-to-end) or in every
    cell that reports the end-to-end metric it moves (per-layer)."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def load_reader(name: str, root: Path = ROOT) -> Callable[[dict], Optional[float]]:
    """The reader of per-layer metric ``name``: ``layer_metrics/<name>.py``,
    or, where there is none, the reader its family shares, named by the
    part before the first dot (``mfu.py`` reads ``mfu.audio`` and
    ``mfu.train``)."""
    folder = root / BENCH_DIR.name / "layer_metrics"
    path = folder / f"{name}.py"
    if not path.exists():
        path = folder / f"{name.split('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.layer_metrics.{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def card_info() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"not available ({type(e).__name__})"
    return out.strip().splitlines()[0]


@dataclass
class Check:
    """One number compared with the reference, and its limit: the number
    passes when it is at most the limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Outcome:
    e2e: dict                     # end-to-end metric name -> value
    attempted: int
    failed: int
    checks: list                  # [Check]


@dataclass
class Cell:
    """One run's context: the cell's files, the run's arguments and what
    the run records for the per-layer readers."""

    name: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float
    control: bool = False
    record: dict = field(default_factory=lambda: {"spans": {}, "counters": {}})
    setup_s: Optional[float] = None
    outside_s: float = 0.0        # set-up seconds that are the benchmark's own, not counted
    peak_bytes: int = 0
    result: Optional[dict] = None

    def log(self, *parts) -> None:
        print(*parts, file=sys.stderr, flush=True)

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            import torch

            torch.cuda.synchronize(self.device)

    def mark(self, label: str) -> None:
        """Log how far into set-up the run is, by the process's clock."""
        self.log(f"setup {label} at {time.perf_counter() - self.t_start:.3f} s")

    def begin_window(self) -> float:
        """Ends set-up (everything is built and warm) and opens the window.
        What set-up left for the garbage collector is collected and frozen
        first, so that no collection of it pauses the window."""
        import gc

        gc.collect()
        gc.freeze()
        self.sync()
        now = time.perf_counter()
        self.setup_s = now - self.t_start - self.outside_s
        self.mark(f"done, window opens ({self.outside_s:.3f} s of it not counted)")
        return now

    @contextlib.contextmanager
    def outside_setup(self):
        """Work of the benchmark's own inside set-up, such as the reference's
        forward that sets the weights' BatchNorm statistics: its seconds
        are left out of ``setup_s``."""
        self.sync()
        t0 = time.perf_counter()
        yield
        self.sync()
        self.outside_s += time.perf_counter() - t0

    @contextlib.contextmanager
    def span(self, name: str):
        """Host time of one call into a layer, kept by name; in a traced
        run also a profiler range ``bench.<name>``, which labels the
        device's idle gaps."""
        ctx = contextlib.nullcontext()
        if self.trace:
            import torch

            ctx = torch.profiler.record_function(f"bench.{name}")
        t0 = time.perf_counter()
        with ctx:
            yield
        self.record["spans"].setdefault(name, []).append(time.perf_counter() - t0)

    def read_peak(self) -> None:
        """The device's memory peak, read before the reference runs."""
        if self.cuda:
            import torch

            self.peak_bytes = int(torch.cuda.max_memory_allocated(self.device))

    def free(self) -> None:
        """Return the program's freed memory to the card before the reference."""
        import gc

        gc.collect()
        if self.cuda:
            import torch

            torch.cuda.empty_cache()


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device=None,
             control: bool = False, t_start: Optional[float] = None, root: Path = ROOT,
             found: Optional[dict] = None, keep: bool = False):
    """Run one cell and return its result line (a dict). ``found``, in
    place of the files under ``root``, gives the cell's entry,
    configuration, traffic and limits (the tests use small ones). With
    ``keep`` the run's ``Cell`` is returned, the line as its ``result``."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    spec = load_spec(root)
    found = find_cell(spec, workload, root) if found is None else found
    device = torch.device("cuda" if device is None else device)
    cell = Cell(workload, found["config"], found["traffic"], found["limits"], int(seed),
                float(seconds), bool(trace), device, t_start, control)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        cell.record["card"] = card_info()
        cell.log(f"card: {cell.record['card']}")
    cell.mark("torch imported, card found")
    driver = importlib.import_module(f"benchmark.drivers.{found['traffic']['driver']}")
    outcome = driver.run(cell)
    e2e = dict(outcome.e2e, setup_s=cell.setup_s)
    cell.record["e2e"] = e2e
    reported = {m["name"] for m in spec["end_to_end"] if applies(m, workload, set())}
    metrics = {}
    if not trace:
        for m in spec["end_to_end"]:
            if m["name"] in reported:
                if m["name"] not in e2e:
                    raise RuntimeError(f"the driver reported no {m['name']}")
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        for m in spec["per_layer"]:
            if applies(m, workload, reported):
                value = load_reader(m["name"], root)(cell.record)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": all(c.ok for c in outcome.checks),
        "attempted": int(outcome.attempted),
        "failed": int(outcome.failed),
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": cell.peak_bytes},
    }
    trace_out = cell.record.get("device_trace")
    if trace and trace_out:
        result["device"]["busy_s"] = trace_out["busy_s"]
        result["device"]["window_s"] = trace_out["window_s"]
        result["breakdown"] = {"device_ops": trace_out["device_ops"],
                               "idle_gaps": trace_out["idle_gaps"]}
    result["card"] = cell.record.get("card", "cpu")
    # a number that is no number (a missing answer reads inf) as a finite one past any limit
    result["checks"] = {c.name: {"value": c.value if math.isfinite(c.value) else 1e30,
                                 "limit": c.limit} for c in outcome.checks}
    if keep:
        cell.result = result
        return cell
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=[0, 1], default=0)
    p.add_argument("--control", action="store_true",
                   help="put the cell's control (a lower precision) in the program's place; "
                   "its check has to come out false")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the H100 only", file=sys.stderr)
        return 2
    spec = load_spec()
    found = find_cell(spec, args.workload)
    chips = int(found["entry"]["chips"])
    if torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} cards, {torch.cuda.device_count()} found",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      control=args.control, t_start=t_start, found=found)
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0

