"""Tiny cells for the CPU tests: the real traffic files with a short
schedule, over the tiny configurations beside this file."""

import json
import time
from pathlib import Path

import torch

from benchmark import harness

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent


def spec(driver: str) -> harness.CellSpec:
    config = json.loads((HERE / {"sample": "mvvdm-tiny.json", "recon": "gs4d-tiny.json",
                                 "refine": "gs4d-tiny.json",
                                 "train": "mvvdm-tiny.json"}[driver]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{driver}.json").read_text())
    if driver == "sample":
        traffic.update(steps=3, freeinit_rounds=2, check_steps=2)
    elif driver == "recon":
        traffic.update(cycle=[175, 75, 25])
    elif driver == "train":
        # the CPU computes in float32: the frozen weights stay float32 there
        traffic.update(clip_frames=6, videos=2, cast_frozen_bf16=False)
    else:
        traffic.update(size=80, guidance_config="tests/mvvdm-tiny-guidance.json",
                       guidance=dict(traffic["guidance"], image_size=80, vae_encode_chunk=4))
        traffic["random_camera"] = dict(traffic["random_camera"], batch_size=8, total_frame=2,
                                        width=80, height=80)
    e2e = [{"name": traffic["metric"], "unit": "s"}, {"name": "setup_s", "unit": "s"}]
    return harness.CellSpec(name=f"{driver}-tiny", chips=1, config_name=config["name"],
                            config=config, traffic_name=driver, traffic=traffic,
                            end_to_end=e2e, per_layer=[])


def run(driver: str, seed: int = 2 ** 31 + 12345, seconds: float = 0.5) -> dict:
    """One run of the tiny cell on the CPU: set-up, window, check."""
    from importlib import import_module

    torch.set_num_threads(4)
    mod = import_module(f"benchmark.drivers.{driver}")
    return harness.run_cell(spec(driver), mod, seed, seconds, False, time.perf_counter(),
                            torch.device("cpu"))
