"""The trainer's data-parallel gradient over NCCL on two cards
(``tests/torch_nccl_worker.py``): the all-reduced mean equals the mean of
the two videos' gradients taken on one card, within the kernels' own
run-to-run spread, so NCCL's float32 reduction adds nothing; the
one-process gradient of both videos in one pass differs from either by
bf16 rounding alone.

Why the one-process run is not bitwise the dp run: the frozen weights and
activations are bf16 and the batch of one pass is twice a rank's, so
cuBLAS and cuDNN pick other algorithms (tile shapes, split-K) for the
doubled rows and round in another order; kernel D's dk / dv meet by f32
atomics where it splits the I2V batches (``flash_bwd_split``), whose order
varies from run to run. The gradient is reduced in float32 (the masters'
dtype), never in bf16. Hence the tolerances: the NCCL mean against the
one-card mean within 1e-6 or four times the run-to-run spread, whichever is
larger; the one-process gradient within 1e-2 relative L2 and its norm
within 2e-3 (an earlier two-card run read 3.06e-4 on the norm: PERF.md
§6)."""

import json
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

WORKER = Path(__file__).resolve().parent / "torch_nccl_worker.py"
DEADLINE_S = 600


@pytest.mark.cuda
def test_nccl_mean_equals_the_one_card_mean(tmp_path):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    logs = [open(tmp_path / f"rank{r}.log", "w") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(tmp_path), str(r), str(port)],
                              stdout=logs[r], stderr=subprocess.STDOUT) for r in range(2)]
    deadline = time.monotonic() + DEADLINE_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"the two ranks did not end within {DEADLINE_S} s")
    finally:
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (tmp_path / f"rank{r}.log").read_text()[-4000:]
    gaps = json.loads((tmp_path / "gaps.json").read_text())
    print(gaps)
    assert gaps["nccl_vs_split"] <= max(1e-6, 4 * gaps["repeat"]), gaps
    assert gaps["one_vs_split"] < 1e-2, gaps
    assert gaps["norm_one_vs_nccl"] < 2e-3, gaps
