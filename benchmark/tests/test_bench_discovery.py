"""run.py finds a cell's configuration, traffic and per-layer metric
files by the names BENCHMARK.json gives them: a new cell is new files and
new entries, with no file that is there edited."""

import hashlib
import json
import shutil
import subprocess
import sys

from benchmark import harness

from .cells import BENCH


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_dropped_in_files_are_found_by_name(tmp_path, monkeypatch):
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(bench)
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    (bench / "configs" / "mvvdm-new.json").write_text(
        (BENCH / "configs" / "mvvdm-sd15.json").read_text())
    traffic = json.loads((BENCH / "traffic" / "sample.json").read_text())
    traffic["guidance_scale"] = 5.0
    (bench / "traffic" / "sample-g5.json").write_text(json.dumps(traffic))
    (bench / "layer_metrics" / "new.metric.py").write_text(
        "def read(t):\n    return 2.0 * t.busy_s\n")
    spec["configs"].append(dict(spec["configs"][0], name="mvvdm-new",
                                file="benchmark/configs/mvvdm-new.json"))
    spec["workloads"].append({"name": "new-cell", "config": "mvvdm-new",
                              "traffic": "sample-g5", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "new.metric", "unit": "%", "better": "higher",
                              "source": "device_trace", "layer": "device",
                              "moves": "sample_step_s", "workloads": ["new-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setattr(harness, "BENCH_DIR", bench)
    cell = harness.load_cell(tmp_path, "new-cell")
    assert cell.config["name"] == "mvvdm-sd15" and cell.traffic["guidance_scale"] == 5.0
    assert [m["name"] for m in cell.per_layer] == ["new.metric"]
    t = harness.TraceSummary(window_s=2.0, busy_s=1.5, kernels={}, launches={}, units=1,
                             config=cell.config)
    assert harness.read_layer_metric("new.metric", t) == 3.0
    after = _digest(bench)
    assert all(after[p] == h for p, h in before.items())


def test_run_refuses_without_a_card_and_prints_no_result(tmp_path):
    # a directory with only BENCHMARK.json and the benchmark's files
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for root in (BENCH.parent, tmp_path):
        out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "sample-256",
                              "--seed", str(2 ** 33 + 7), "--seconds", "1", "--trace", "0"],
                             cwd=root, capture_output=True, text=True)
        assert out.returncode != 0
        assert out.stdout.strip() == ""


def test_idle_gaps_are_labelled_by_the_innermost_span():
    spans = [(0.0, 100.0, "request"), (10.0, 40.0, "sampler.unet")]

    class E:
        def __init__(self, name, a, b, dev):
            from torch.autograd import DeviceType

            self.name = name
            self.time_range = type("R", (), {"start": a, "end": b})()
            self.device_type = DeviceType.CUDA if dev else DeviceType.CPU

    class P:
        def events(self):
            ev = [E("bench.window", 0.0, 100.0, False)]
            ev += [E(n, a, b, False) for a, b, n in spans]
            ev += [E("k1", 0.0, 20.0, True), E("k2", 30.0, 50.0, True), E("k1", 60.0, 90.0, True)]
            return ev

    out = harness.summarise(P(), "bench.window", {"request", "sampler.unet"})
    assert abs(out["busy_s"] - 70e-6) < 1e-12
    gaps = dict(out["idle_gaps"])
    assert abs(gaps["sampler.unet"] - 10e-6) < 1e-12
    assert abs(gaps["request"] - 20e-6) < 1e-12
    assert out["kernels"]["k1"][1] == 2
