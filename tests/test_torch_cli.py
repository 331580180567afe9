"""The port's sampling CLI on the CPU, its device rule, and its isolation
from JAX and the JAX package."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "animate3d_tpu_torch"


def _cond_images(root, n=4, size=16):
    rng = np.random.default_rng(0)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8)).save(
            os.path.join(root, f"{i}.png"))


def test_cli_tiny_on_cpu_writes_multiframe_gif(tmp_path):
    from animate3d_tpu_torch.cli.inference import main

    _cond_images(tmp_path)
    res = main(["--device", "cpu", "--model_size", "tiny", "-W", "16", "-H", "16",
                "-L", "2", "--steps", "2", "--freeinit_iters", "2", "--seed", "1",
                "--ip_image_root", str(tmp_path), "--output_dir", str(tmp_path / "out")])
    assert os.path.exists(res["gif"])
    with Image.open(res["gif"]) as gif:
        assert gif.n_frames == 2
        assert gif.size == (4 * 16, 16)
    assert res["latents"].shape == (4, 2, 8, 8, 4)  # tiny VAE: 2 levels, factor 2
    assert torch.isfinite(res["latents"]).all()
    assert len(res["step_seconds"]) == 4  # 2 steps x 2 FreeInit iterations


def test_cli_without_device_cpu_raises_on_a_host_without_cuda(tmp_path):
    from animate3d_tpu_torch.cli.inference import main

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    _cond_images(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--model_size", "tiny", "-W", "16", "-H", "16", "-L", "2", "--steps", "1",
              "--ip_image_root", str(tmp_path), "--output_dir", str(tmp_path / "out")])


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    banned = ("jax", "jaxlib", "flax", "optax", "orbax", "animate3d_tpu")
    bad = [m for m in _imports(path) if m.split(".")[0] in banned]
    assert not bad, f"{path} imports {bad}"


def test_chip_smoke_takes_the_shared_constants():
    """chip_smoke.py's peaks, kernel families and launch counters are the
    very objects of ``benchmark/counts`` and ``ops/_build.py``, not copies."""
    import chip_smoke
    from animate3d_tpu_torch.ops import _build
    from benchmark.counts import families, peaks

    for name in ("PEAK_BF16_FLOPS", "PEAK_F32_FLOPS", "PEAK_BYTES", "PEAK_EX2"):
        assert getattr(chip_smoke, name) is getattr(peaks, name), name
    assert chip_smoke.family is families.family
    assert chip_smoke.COUNTERS is _build.COUNTERS


def test_importing_the_port_loads_no_jax():
    code = ("import sys, pkgutil, importlib, animate3d_tpu_torch\n"
            "for m in pkgutil.walk_packages(animate3d_tpu_torch.__path__, 'animate3d_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'animate3d_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, timeout=120)
