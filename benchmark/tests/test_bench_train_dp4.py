"""The dp-4 trainer cell (``drivers/train_dp4.py``) on a tiny MV-VDM on the
CPU: four gloo processes, rank 0 the test's. Rank 0's window closes after
a fraction of a second; every rank then stops after the same step, meets
the others at the barrier and exits within the join bound, and the check
holds the global step to the reference's mean over the four videos."""

import json
import time

import pytest
import torch

from benchmark import harness

from .cells import BENCH, HERE

JOIN_BOUND_S = 60.0


def _spec() -> harness.CellSpec:
    config = json.loads((HERE / "mvvdm-tiny.json").read_text())
    traffic = json.loads((BENCH / "traffic" / "train_dp4.json").read_text())
    # the CPU computes in float32: the frozen weights stay float32 there
    traffic.update(clip_frames=6, cast_frozen_bf16=False, pg_timeout_s=120, join_s=60)
    e2e = [{"name": "train_step_s", "unit": "s"}, {"name": "setup_s", "unit": "s"}]
    return harness.CellSpec(name="train-dp4-tiny", chips=4, config_name=config["name"],
                            config=config, traffic_name="train_dp4", traffic=traffic,
                            end_to_end=e2e, per_layer=[])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from benchmark.drivers import train_dp4

    torch.set_num_threads(2)
    ctx = harness.Ctx(spec=_spec(), seed=2 ** 31 + 5417, device=torch.device("cpu"),
                      tmp=str(tmp_path_factory.mktemp("dp4")))
    state = train_dp4.setup(ctx)
    win = harness.Window(0.3, torch.device("cpu"))
    win.open()
    with pytest.raises(harness.WindowClosed):
        train_dp4.window(state, win)
    t0 = time.perf_counter()
    train_dp4.leave(state)
    left_s = time.perf_counter() - t0
    return {"state": state, "win": win, "left_s": left_s,
            "checks": train_dp4.check(state)}


def test_every_rank_runs_the_same_steps_and_leaves_within_the_bound(run):
    state, win = run["state"], run["win"]
    assert win.units >= 1
    assert state.rank_steps == [state.k] * 4, state.rank_steps
    assert run["left_s"] < JOIN_BOUND_S
    assert all(p.poll() is not None for p in state.procs)


def test_global_step_matches_the_reference_mean(run):
    checks = run["checks"]
    assert set(checks) == {"loss_rel", "grad_gap", "change_gap"}
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks


def test_dp4_traffic_names_its_driver_and_bounds_every_wait():
    traffic = json.loads((BENCH / "traffic" / "train_dp4.json").read_text())
    assert traffic["driver"] == "train_dp4" and traffic["dp"] == 4 and traffic["zero"]
    assert traffic["metric"] == "train_step_s" and traffic["batch_size"] == 1
    assert 0 < traffic["join_s"] < traffic["pg_timeout_s"] < 900


def test_comm_share_reads_nccl_kernels_only():
    t = harness.TraceSummary(window_s=10.0, busy_s=8.0, units=4, config={},
                             kernels={"ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)": [2.0, 4],
                                      "flash_fwd_kernel<48>": [5.0, 10]}, launches={})
    assert harness.read_layer_metric("train_dp4.comm_share", t) == pytest.approx(25.0)
    empty = harness.TraceSummary(window_s=10.0, busy_s=8.0, units=4, config={}, kernels={},
                                 launches={})
    assert harness.read_layer_metric("train_dp4.comm_share", empty) is None
