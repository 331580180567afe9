"""The frozen reference against the port at tiny sizes on the CPU: a whole
run of each tiny cell (set-up, window, check) reads correct, its numbers
at rounding, and the control (the reference one precision step down, in
the program's place) fails the sampling cell's limits."""

import json

import pytest
import torch

from benchmark import harness
from benchmark.drivers import recon, sample

from . import cells


def test_sample_cell_agrees_with_the_reference():
    res = cells.run("sample")
    assert res["correct"], res["checks"]
    assert all(c["value"] <= 1e-5 for c in res["checks"].values()), res["checks"]
    assert res["attempted"] >= 1 and res["metrics"]["sample_step_s"]["value"] > 0


def test_recon_cell_agrees_with_the_reference():
    res = cells.run("recon")
    assert res["correct"], res["checks"]
    assert all(c["value"] <= 1e-5 for c in res["checks"].values()), res["checks"]


def test_sample_control_fails(tmp_path):
    torch.set_num_threads(4)
    ctx = harness.Ctx(spec=cells.spec("sample"), seed=2 ** 32 + 3, device=torch.device("cpu"),
                      tmp=str(tmp_path))
    out = sample.calibrate(ctx, control=True)
    limits = ctx.spec.traffic["limits"]
    assert all(v <= limits[k] for k, v in out["program"].items()), out
    assert any(v > limits[k] for k, v in out["control"].items()), out


@pytest.mark.cuda
def test_recon_control_fails(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("the recon control is TF32, which only the card computes")
    ctx = harness.Ctx(spec=cells.spec("recon"), seed=2 ** 32 + 3, device=torch.device("cuda"),
                      tmp=str(tmp_path))
    out = recon.calibrate(ctx, control=True)
    limits = ctx.spec.traffic["limits"]
    assert any(v > limits[k] for k, v in out["control"].items()), out


def test_reference_tokenizer_matches_the_written_vocabulary(tmp_path):
    from animate3d_tpu_torch.utils.tokenizer import (ClipTokenizer, find_tokenizer_files,
                                                     write_char_level_tokenizer)
    from benchmark.reference.sd.pipeline import char_tokens

    write_char_level_tokenizer(str(tmp_path))
    tok = ClipTokenizer(*find_tokenizer_files(str(tmp_path)))
    texts = ["a butterfly flapping its wings", "", "A  Robot, waving! 42 times"]
    assert torch.equal(torch.as_tensor(tok(texts), dtype=torch.long), char_tokens(texts))
    assert json.loads((tmp_path / "vocab.json").read_text())
