"""The import guard compares whole top-level names."""

import sys
import types

from benchmark import harness


def test_guard_flags_jax_and_the_jax_package_only(monkeypatch):
    assert harness.forbidden_modules() == [] or "animate3d_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "animate3d_tpu_torch_fake", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax_lookalike", types.ModuleType("x"))
    assert "animate3d_tpu" not in harness.forbidden_modules()
    assert "jax" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "animate3d_tpu.models.unet_mv", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "flax.linen", types.ModuleType("x"))
    found = harness.forbidden_modules()
    assert {"animate3d_tpu", "jaxlib", "flax"} <= set(found)


def test_benchmark_and_reference_import_no_jax_or_program():
    import subprocess

    code = ("import sys; sys.path.insert(0, '.');"
            "import benchmark.harness, benchmark.readers, benchmark.calibrate;"
            "import benchmark.reference.sd.pipeline, benchmark.reference.gs.system;"
            "import benchmark.counts.kernels, benchmark.counts.families;"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'animate3d_tpu', 'animate3d_tpu_torch'));"
            "print(bad); assert not bad")
    from .cells import BENCH

    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent, capture_output=True,
                         text=True)
    assert out.returncode == 0, out.stdout + out.stderr
