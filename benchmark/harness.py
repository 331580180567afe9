"""The cell-independent part of a run: finding a cell's files by name, the
measured window, the trace's reduction, the import guard and the result
line. Drivers (``drivers/<name>.py``) provide ``setup(ctx)``,
``window(state, win)``, ``trace_counts(state)`` and ``check(state)``."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "animate3d_tpu")


# -- finding a cell's files ---------------------------------------------------

@dataclass
class CellSpec:
    name: str
    chips: int
    config_name: str
    config: Dict[str, Any]
    traffic_name: str
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def _for_cell(metrics: List[dict], workload: str) -> List[dict]:
    return [m for m in metrics if workload in m.get("workloads", [workload])]


def load_cell(root: Path, workload: str) -> CellSpec:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its
    configuration file, its traffic file and the metrics it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"[bench] no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    traffic = json.loads((BENCH_DIR / "traffic" / f"{cell['traffic']}.json").read_text())
    return CellSpec(name=workload, chips=int(cell["chips"]), config_name=cfg["name"],
                    config=json.loads((root / cfg["file"]).read_text()),
                    traffic_name=cell["traffic"], traffic=traffic,
                    end_to_end=_for_cell(bench["end_to_end"], workload),
                    per_layer=_for_cell(bench["per_layer"], workload))


def fix_cache_dirs(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths; no
    library loads JAX on its own."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(root / ".bench_cache" / sub)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that are JAX's or the JAX
    package's, compared whole (``animate3d_tpu_torch`` is not
    ``animate3d_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def seed_for(seed: int, *parts) -> int:
    """A sub-seed for one use of the run's seed (any size of seed)."""
    h = seed % (1 << 62)
    for p in parts:
        h = (h * 1000003 + (p if isinstance(p, int) else sum(map(ord, str(p))))) % (1 << 62)
    return h


# -- spans ---------------------------------------------------------------------

def span(name: str):
    """A host span around one call into a layer: a ``record_function``
    range, which the trace labels idle gaps with."""
    import torch

    return torch.profiler.record_function(name)


# -- the measured window --------------------------------------------------------

class WindowClosed(Exception):
    """Raised by :meth:`Window.tick` once the window's time is up."""


class Window:
    """Counts the units of work done from :meth:`open` on. ``tick`` after a
    unit; once ``seconds`` have passed, the device is synchronised, the
    close time taken and :class:`WindowClosed` raised. The metric is the
    elapsed time over the units, all the window's work over all its time."""

    def __init__(self, seconds: float, device):
        self.seconds, self.device = float(seconds), device
        self.t0 = self.t_end = None
        self.units = 0

    def _sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def open(self) -> None:
        self._sync()
        self.t0 = time.perf_counter()
        self.units = 0

    def tick(self, n: int = 1) -> None:
        self.units += n
        if time.perf_counter() - self.t0 >= self.seconds:
            self._sync()
            self.t_end = time.perf_counter()
            raise WindowClosed

    @property
    def elapsed(self) -> float:
        return self.t_end - self.t0


# -- the trace -------------------------------------------------------------------

@dataclass
class TraceSummary:
    """What the per-layer readers read: the traced window's length, the
    device's busy time in it, device time and count by kernel name, the
    program's launch counters over the window, the units of work done and
    the driver's counted operations (``counts``)."""

    window_s: float
    busy_s: float
    kernels: Dict[str, List[float]]
    launches: Dict[tuple, int]
    units: int
    config: Dict[str, Any]
    counts: Dict[str, float] = field(default_factory=dict)
    idle_gaps: List[list] = field(default_factory=list)

    def kernel_seconds(self, *needles: str) -> float:
        """Device seconds of the kernels whose name holds any of ``needles``
        (lower case)."""
        return sum(s for name, (s, _) in self.kernels.items()
                   if any(n in name.lower() for n in needles))


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarise(prof, window_name: str, span_names) -> dict:
    """Busy time (union of device activity), kernel totals and idle gaps by
    the innermost host span open at each gap, all within the host range
    ``window_name``."""
    from torch.autograd import DeviceType

    events = prof.events()
    win = [e for e in events if e.name == window_name]
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    dev, kernels, spans = [], {}, []
    names = set(span_names) | {window_name}
    for e in events:
        if e.device_type == DeviceType.CUDA and not (
                e.name in names or getattr(e, "is_user_annotation", False)):
            a, b = max(e.time_range.start, w0), min(e.time_range.end, w1)
            if b > a:
                dev.append((a, b))
                k = kernels.setdefault(e.name, [0.0, 0])
                k[0] += (b - a) * 1e-6
                k[1] += 1
        elif e.device_type != DeviceType.CUDA and e.name in span_names:
            spans.append((e.time_range.start, e.time_range.end, e.name))
    busy = _merge(dev)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    # host spans nest on the thread that opens them: a sweep with a stack
    # finds the innermost span open at each gap's middle
    spans.sort(key=lambda s: (s[0], -s[1]))
    gaps: Dict[str, float] = {}
    stack, i = [], 0
    for a, b in idle:
        mid = 0.5 * (a + b)
        while i < len(spans) and spans[i][0] <= mid:
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        label = stack[-1][2] if stack else "outside any span"
        gaps[label] = gaps.get(label, 0.0) + (b - a) * 1e-6
    return dict(window_s=(w1 - w0) * 1e-6, busy_s=sum(b - a for a, b in busy) * 1e-6,
                kernels=kernels, idle_gaps=sorted(([k, v] for k, v in gaps.items()),
                                                  key=lambda kv: -kv[1]))


def read_layer_metric(name: str, trace: TraceSummary) -> Optional[float]:
    """``layer_metrics/<name>.py``'s ``read(trace)``; None where it finds
    nothing to read."""
    path = BENCH_DIR / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_layer_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(trace)


# -- a run -----------------------------------------------------------------------

@dataclass
class Ctx:
    """What a driver's ``setup`` gets: the cell, the seed, the device and a
    scratch directory under ``TMPDIR`` (removed at the end of the run)."""

    spec: CellSpec
    seed: int
    device: Any
    tmp: str


def _launch_snapshot():
    try:
        from animate3d_tpu_torch.ops import _build
    except ImportError:
        return {}
    return dict(_build.LAUNCHES)


def run_cell(spec: CellSpec, driver, seed: int, seconds: float, trace: bool,
             t_start: float, device) -> dict:
    import torch

    tmp = tempfile.mkdtemp(prefix="bench-")
    try:
        ctx = Ctx(spec=spec, seed=seed, device=device, tmp=tmp)
        state = driver.setup(ctx)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        win = Window(seconds, device)
        before = _launch_snapshot()
        prof = None
        if trace:
            # the profiler's reduction costs about ten seconds a traced
            # second: the traffic's ``trace_seconds`` bound the traced part,
            # from the window's start (the units done in it are counted)
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            prof = torch.profiler.profile(activities=acts)
            win.seconds = min(win.seconds, float(spec.traffic.get("trace_seconds", seconds)))
            prof.start()
        try:
            with span("bench.window"):
                win.open()
                try:
                    driver.window(state, win)
                except WindowClosed:
                    pass
        finally:
            if prof is not None:
                prof.stop()
        if win.t_end is None:
            raise RuntimeError("the driver's window returned before its time was up")
        setup_s = win.t0 - t_start
        peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
        after = _launch_snapshot()
        launches = {k: n - before.get(k, 0) for k, n in after.items() if n - before.get(k, 0)}
        device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                       "kind": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
                       "count": spec.chips, "memory_peak_bytes": peak}
        breakdown = None
        if trace:
            summary = summarise(prof, "bench.window", set(spec.traffic.get("spans", [])))
            del prof
            ts = TraceSummary(window_s=summary["window_s"], busy_s=summary["busy_s"],
                              kernels=summary["kernels"], launches=launches,
                              units=win.units, config=spec.config,
                              counts=driver.trace_counts(state, win),
                              idle_gaps=summary["idle_gaps"])
            metrics = {}
            for m in spec.per_layer:
                value = read_layer_metric(m["name"], ts)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            device_info.update(busy_s=ts.busy_s, window_s=ts.window_s)
            top = sorted(ts.kernels.items(), key=lambda kv: -kv[1][0])[:10]
            breakdown = {"device_ops": [[k[:160], v[0]] for k, v in top],
                         "idle_gaps": ts.idle_gaps[:10]}
        else:
            values = {spec.traffic["metric"]: win.elapsed / max(win.units, 1),
                      "setup_s": setup_s}
            metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                       for m in spec.end_to_end if m["name"] in values}
        print(f"[bench] {spec.name}: {win.units} units in {win.elapsed:.4f} s, set-up "
              f"{setup_s:.4f} s, peak {peak} bytes", file=sys.stderr)
        checks = driver.check(state)
        del state
        result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
                  "attempted": win.units, "failed": 0, "metrics": metrics,
                  "device": device_info}
        if breakdown is not None:
            result["breakdown"] = breakdown
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def emit(result: dict) -> None:
    """Each number compared beside its limit as the last lines of standard
    error; the result as the last line of standard output."""
    for name, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
