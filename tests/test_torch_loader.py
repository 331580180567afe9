"""The port's native loader (``animate3d_tpu_torch/data/native_loader.py``,
built from ``native/mvloader.cpp`` into the port's ``_build/``) and the
trainer dataset's frame reading against the JAX package's on the same files:
PNG / JPEG sequences, mp4 clips (written by the port's ``encode_video``) and
a 512 → 256 downscale, which the port once read with PIL's LANCZOS where the
JAX package reads through the native area downscale."""

import json

import numpy as np
import pytest
from PIL import Image

from animate3d_tpu.data import native_loader as JN
from animate3d_tpu.data import video_dataset as JD
from animate3d_tpu_torch.data import native_loader as TN
from animate3d_tpu_torch.data import video_dataset as TD


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    """Seeded stills (PNG and JPEG at 64² and 512²), three 4-frame PNG
    directories of 512² frames and three 12-frame mp4 clips of 64²."""
    root = tmp_path_factory.mktemp("media")
    rng = np.random.default_rng(0)
    for size in (64, 512):
        img = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
        Image.fromarray(img).save(root / f"s{size}.png")
        Image.fromarray(img).save(root / f"s{size}.jpg", quality=90)
    for v in range(3):
        d = root / f"dir{v}"
        d.mkdir()
        for f in range(4):
            Image.fromarray(rng.integers(0, 255, (512, 512, 3), dtype=np.uint8)).save(
                d / f"{f}.png")
        # a moving gradient: smooth content the codec keeps
        yy, xx = np.mgrid[0:64, 0:64]
        clip = np.stack([np.stack([(xx * 4 + 16 * t + 40 * v) % 256, yy * 4,
                                   np.full_like(xx, 60 * v)], -1) for t in range(12)])
        assert TN.encode_video(str(root / f"clip{v}.mp4"), clip.astype(np.uint8), fps=8)
    (root / "bad.mp4").write_bytes(b"\0" * 64)
    return root


def test_the_port_builds_its_own_library():
    assert TN.available(), TN.build_error()
    path = TN._LOADER.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "animate3d_tpu_torch"


@pytest.mark.parametrize("name,size", [("s64.png", 64), ("s512.png", 256), ("s512.jpg", 256),
                                       ("s64.jpg", 96)])
def test_decode_images_equals_jax(media, name, size):
    paths = [str(media / name)] * 2
    port, ref = TN.decode_images(paths, size), JN.decode_images(paths, size)
    assert port.shape == (2, size, size, 3)
    np.testing.assert_array_equal(port, ref)


def test_decode_video_and_frame_count_equal_jax(media):
    for v in range(3):
        path = str(media / f"clip{v}.mp4")
        assert TN.video_frame_count(path) == JN.video_frame_count(path) == 12
        for size in (64, 32):
            idx = [0, 5, 11, 30]  # past the end clamps to the last frame
            port, ref = TN.decode_video(path, idx, size), JN.decode_video(path, idx, size)
            np.testing.assert_array_equal(port, ref)
            np.testing.assert_array_equal(port[-1], port[-2])


def test_mp4_round_trip_within_the_codec(tmp_path):
    """Flat frames survive the encoder (test_native_loader.py's pattern)."""
    frames = np.stack([np.full((32, 32, 3), 40 * i, np.uint8) for i in range(5)])
    assert TN.encode_video(str(tmp_path / "flat.mp4"), frames, fps=8)
    out = TN.decode_video(str(tmp_path / "flat.mp4"), list(range(5)), 32)
    expect = frames.astype(np.float32) / 127.5 - 1.0
    assert np.abs(out - expect).max() < 0.05


def _manifest(root, name, videos):
    path = root / f"{name}.json"
    path.write_text(json.dumps([{"videos": videos, "caption": "c", "azimuth_start": 30.0}]))
    return str(path)


@pytest.mark.parametrize("kind,size,frames,total", [
    ("mp4", 32, 4, 12),  # mp4 items (the train.yaml manifest's kind)
    ("dir", 512, 2, 4),  # frame directories at the source size
    ("dir", 256, 2, 4),  # 512 → 256: the repaired downscale
])
def test_dataset_item_equals_jax(media, kind, size, frames, total):
    """The same manifest and seed through both packages' MVideoDataset: the
    same stride phases, pixels (bit for bit) and cameras."""
    videos = ([f"clip{v}.mp4" for v in (0, 1, 2, 0)] if kind == "mp4"
              else [f"dir{v}" for v in (0, 1, 2, 0)])
    manifest = _manifest(media, kind, videos)
    kw = dict(manifest_path=manifest, video_root=str(media), sample_size=size,
              sample_n_frames=frames, total_frames=total)
    port = TD.MVideoDataset(TD.MVideoConfig(**kw), seed=3)
    ref = JD.MVideoDataset(JD.MVideoConfig(**kw), seed=3)
    for _ in range(2):
        a, b = port[0], ref[0]
        assert a["pixel_values"].shape == (4, frames, size, size, 3)
        np.testing.assert_array_equal(a["pixel_values"], b["pixel_values"])
        np.testing.assert_allclose(a["cameras"], b["cameras"], atol=1e-6)
        assert a["text"] == b["text"]


def test_the_rows_a_rank_keeps_are_the_global_batch_rows(media):
    """``iterate(keep=...)`` draws every item's phase and reads its rows
    only: the rows equal those of the whole batch."""
    manifest = _manifest(media, "rows", [f"clip{v}.mp4" for v in (0, 1, 2, 0)])
    kw = dict(manifest_path=manifest, video_root=str(media), sample_size=16, sample_n_frames=2,
              total_frames=12)
    whole = next(TD.MVideoDataset(TD.MVideoConfig(**kw), seed=1).iterate(batch_size=4))
    half = next(TD.MVideoDataset(TD.MVideoConfig(**kw), seed=1).iterate(batch_size=4,
                                                                         keep=slice(2, 4)))
    np.testing.assert_array_equal(half["pixel_values"], whole["pixel_values"][2:4])
    assert half["text"] == whole["text"][2:4]


def test_corrupt_mp4_raises_in_both(media):
    assert TN.decode_video(str(media / "bad.mp4"), [0], 16) is None
    assert TN.video_frame_count(str(media / "bad.mp4")) is None
    idx = np.arange(2)
    with pytest.raises(RuntimeError, match="native"):
        TD._read_frames(str(media / "bad.mp4"), idx, 16)
    with pytest.raises(RuntimeError, match="native"):
        JD._read_video_frames(str(media / "bad.mp4"), idx, 16)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P"])
@pytest.mark.parametrize("size", [64, 32])
def test_pil_fallback_reads_every_mode_as_rgb(tmp_path, monkeypatch, mode, size):
    """With the native decoder unavailable, a still of any PNG mode reads
    as (n, size, size, 3): RGB and RGBA equal the JAX package's fallback
    bit for bit; grey, grey + alpha and palette stills read as PIL's RGB
    conversion of them (LANCZOS where resized)."""
    rng = np.random.default_rng(4)
    img = Image.fromarray(rng.integers(0, 255, (64, 64, 4), dtype=np.uint8), "RGBA")
    img = img.convert(mode) if mode != "P" else img.convert("RGB").quantize(16)
    path = str(tmp_path / f"still_{mode}.png")
    img.save(path)
    monkeypatch.setattr(TN, "decode_images", lambda paths, size: None)
    monkeypatch.setattr(JN, "decode_images", lambda paths, size: None)
    idx = np.arange(2)
    port = TD._read_frames(path, idx, size)
    assert port.shape == (2, size, size, 3)
    if mode in ("RGB", "RGBA"):
        np.testing.assert_array_equal(port, JD._read_video_frames(path, idx, size))
    else:
        rgb = Image.open(path).convert("RGB")
        if size != 64:
            rgb = rgb.resize((size, size), Image.LANCZOS)
        expect = np.asarray(rgb).astype(np.float32) / 127.5 - 1.0
        np.testing.assert_array_equal(port, np.stack([expect] * 2))
