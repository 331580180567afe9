"""The port's mesh-animation tools (``animate3d_tpu_torch/utils/mesh.py``,
``animate3d_tpu_torch/tools/*``) against the JAX package's on the same
inputs, mirroring tests/test_tools.py, and the whole mesh chain driven on
the CPU at tiny size: OBJ → ``mesh2gaussian`` → the static four-view render
(``visualize_four_view_static.yaml``) → a motion video rendered by the port
→ 4-view GIF → ``split_gif`` → ``tracking`` → the mesh recon
(``mesh_animation_frame_16.yaml``) → ``--export`` → ``export_animated_mesh``.
"""

import json
import os
import struct

import numpy as np
import pytest
import torch
from PIL import Image

from animate3d_tpu.tools import export_animated_mesh as JX
from animate3d_tpu.tools import mesh2gaussian as JM
from animate3d_tpu.tools import tracking as JTR
from animate3d_tpu.utils import mesh as JMESH
from animate3d_tpu_torch.tools import export_animated_mesh as TX
from animate3d_tpu_torch.tools import mesh2gaussian as TM
from animate3d_tpu_torch.tools import tracking as TTR
from animate3d_tpu_torch.utils import mesh as TMESH


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's torch ops on one thread: they are many and small
    (a window readout per offset and frame, tiny UNets), and under the
    parallel test workers' load OpenMP's thread team makes each of them
    tens of times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_textured_sphere(d, rows: int, cols: int, seed: int = 0) -> str:
    """A UV sphere of radius 0.4 (rows x cols vertices, the seam duplicated)
    with ``vt`` coordinates, an MTL and a seeded 64² PNG texture."""
    os.makedirs(d, exist_ok=True)
    i, j = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    theta, phi = np.pi * (i + 0.5) / rows, 2 * np.pi * j / (cols - 1)
    v = 0.4 * np.stack([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi),
                        np.cos(theta)], -1).reshape(-1, 3)
    uv = np.stack([j / (cols - 1), 1 - (i + 0.5) / rows], -1).reshape(-1, 2)
    q = (i * cols + j)[:-1, :-1].reshape(-1)
    faces = np.concatenate([np.stack([q, q + cols, q + 1], 1),
                            np.stack([q + 1, q + cols, q + cols + 1], 1)])
    tex = np.random.default_rng(seed).integers(0, 255, (8, 8, 3), dtype=np.uint8)
    Image.fromarray(tex).resize((64, 64), Image.BILINEAR).save(os.path.join(d, "tex.png"))
    with open(os.path.join(d, "asset.mtl"), "w") as f:
        f.write("newmtl m0\nmap_Kd tex.png\n")
    path = os.path.join(d, "asset.obj")
    with open(path, "w") as f:
        f.write("mtllib asset.mtl\nusemtl m0\n")
        f.writelines(f"v {a:.6f} {b:.6f} {c:.6f}\n" for a, b, c in v)
        f.writelines(f"vt {a:.6f} {b:.6f}\n" for a, b in uv)
        f.writelines(f"f {a + 1}/{a + 1} {b + 1}/{b + 1} {c + 1}/{c + 1}\n" for a, b, c in faces)
    return path


def test_split_gif_roundtrip(tmp_path):
    from animate3d_tpu_torch.tools.split_gif import split_gif

    n_views, n_frames, size = 4, 3, 16
    vals = np.arange(n_views * n_frames).reshape(n_views, n_frames) * 5 + 10
    frames = [Image.fromarray(np.concatenate(
        [np.full((size, size, 3), vals[v, fi], np.uint8) for v in range(n_views)], axis=1))
        for fi in range(n_frames)]
    gif = tmp_path / "mv.gif"
    frames[0].save(gif, save_all=True, append_images=frames[1:], duration=100)
    assert split_gif(str(gif), str(tmp_path / "split"), n_views) == n_frames
    for v in range(n_views):
        for fi in range(n_frames):
            img = np.asarray(Image.open(tmp_path / "split" / f"{v * n_frames + fi}.png"))
            assert abs(int(img[0, 0, 0]) - int(vals[v, fi])) <= 2


def test_process_rodin_matches_jax(tmp_path):
    from animate3d_tpu.tools.process_rodin import process as jax_process
    from animate3d_tpu_torch.tools.process_rodin import process

    for sub, fn in (("port", process), ("jax", jax_process)):
        (tmp_path / sub).mkdir()
        (tmp_path / sub / "a.obj").write_text("mtllib base.mtl\nv 0 0 0\nf 1 1 1\n")
        fn(str(tmp_path / sub / "a.obj"), texture_name="tex.png")
    content = (tmp_path / "port" / "a.obj").read_text()
    assert content.index("mtllib") < content.index("usemtl Material")
    for name in ("a.obj", "base.mtl"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    assert "map_Kd tex.png" in (tmp_path / "port" / "base.mtl").read_text()


def test_load_obj_and_vertex_colours_match_jax(tmp_path):
    """The OBJ reader with the MTL texture lookup and the per-vertex texture
    colours, edges and connectivity, against the JAX module's (exact)."""
    path = write_textured_sphere(str(tmp_path), 6, 9)
    a, b = TMESH.load_obj(path), JMESH.load_obj(path)
    for field in ("verts", "faces", "uvs", "face_uvs", "texture"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)
    np.testing.assert_array_equal(TMESH.vertex_colors(a), JMESH.vertex_colors(b))
    np.testing.assert_array_equal(TMESH.mean_abs_edge_vectors(a.verts, a.faces),
                                  JMESH.mean_abs_edge_vectors(b.verts, b.faces))
    assert TMESH.edge_connectivity(a.verts, a.faces) == JMESH.edge_connectivity(b.verts, b.faces)


def test_mesh_to_gaussians_and_connectivity_match_jax(tmp_path):
    """``mesh_to_gaussians`` arrays (atol 1e-6) and the written .ply and
    connectivity JSON against the JAX tool's."""
    from animate3d_tpu.gaussians.ply import read_gaussian_ply as jax_read_ply

    path = write_textured_sphere(str(tmp_path), 7, 11, seed=2)
    port, ref = TM.mesh_to_gaussians(path), JM.mesh_to_gaussians(path)
    for field in ("xyz", "features_dc", "features_rest", "opacity", "scaling", "rotation"):
        np.testing.assert_allclose(getattr(port, field).numpy(), np.asarray(getattr(ref, field)),
                                   atol=1e-6, rtol=0, err_msg=field)
    TM.run(path, str(tmp_path / "port"), "asset")
    JM.run(path, str(tmp_path / "jax"), "asset")
    assert json.loads((tmp_path / "port" / "asset.json").read_text()) == \
        json.loads((tmp_path / "jax" / "asset.json").read_text())
    a, b = (jax_read_ply(str(tmp_path / d / "asset.ply")) for d in ("port", "jax"))
    for field in ("xyz", "features_dc", "opacity", "scaling", "rotation"):
        np.testing.assert_array_equal(np.asarray(getattr(a, field)),
                                      np.asarray(getattr(b, field)), err_msg=field)


def test_chroma_segmentation_matches_jax():
    h = w = 32
    frames = np.ones((3, h, w, 3), np.float32)
    for fi in range(3):
        frames[fi, 8 + fi: 16 + fi, 8:16] = 0.2
    template = np.zeros((h, w), np.float32)
    template[8:16, 8:16] = 1.0
    masks = TTR.segment_video(frames, template, backend="chroma")
    assert masks.shape == (3, h, w)
    assert masks[0, 10, 10] == 1.0 and masks[0, 2, 2] == 0.0 and masks[2, 17, 10] == 1.0
    np.testing.assert_array_equal(masks, JTR.segment_video(frames, template, backend="chroma"))


def _disk_sequence(bg="gradient", n=8, res=64):
    """A moving coloured disk over a gradient (or white) background."""
    yy, xx = np.mgrid[0:res, 0:res].astype(np.float32)
    bg_img = (np.stack([xx / res, yy / res, 0.5 + 0 * xx], -1) if bg == "gradient"
              else np.ones((res, res, 3), np.float32))
    frames, gts = [], []
    for i in range(n):
        disk = ((xx - 20 - 2.5 * i) ** 2 + (yy - 26 - 1.5 * i) ** 2) < 100
        img = bg_img.copy()
        img[disk] = (0.8, 0.2, 0.1)
        frames.append(img)
        gts.append(disk.astype(np.float32))
    return np.stack(frames), np.stack(gts)


def _iou(a, b):
    return np.logical_and(a > 0.5, b > 0.5).sum() / max(np.logical_or(a > 0.5, b > 0.5).sum(), 1)


def test_propagation_features_match_scipy():
    """The torch features (gaussian blur, sobel over y, x and the channel
    axis in scipy's reflect mode) against the JAX module's scipy ones:
    atol 1e-5 (f32 sums in another order)."""
    img = np.random.default_rng(3).uniform(size=(20, 24, 3)).astype(np.float32)
    np.testing.assert_allclose(TTR._propagation_features(torch.from_numpy(img)).numpy(),
                               JTR._propagation_features(img), atol=1e-5, rtol=0)


@pytest.mark.parametrize("bg", ["gradient", "white"])
def test_propagation_masks_match_jax(bg):
    """The propagation backend tracks the disk (IoU > 0.8 every frame, as
    tests/test_tools.py asks) and its masks equal the JAX module's but for
    at most 0.1% of the pixels (thresholds at 0.3 / 0.5 / 0.7 on an f32
    readout summed in another order)."""
    frames, gts = _disk_sequence(bg)
    masks = TTR.segment_video(frames, gts[0], backend="propagation", device="cpu")
    ref = JTR.segment_video(frames, gts[0], backend="propagation")
    assert masks.shape == ref.shape and min(_iou(m, g) for m, g in zip(masks, gts)) > 0.8
    assert (masks != ref).mean() <= 1e-3


def test_chroma_fails_where_propagation_succeeds():
    frames, gts = _disk_sequence("gradient")
    assert _iou(TTR.segment_video(frames, gts[0], backend="chroma")[-1], gts[-1]) < 0.5


def test_xmem_backend_refuses(monkeypatch):
    """Without a checkpoint (no ``weights=``, no ``$XMEM_WEIGHTS``) the xmem
    backend raises in both packages rather than track with random weights."""
    monkeypatch.delenv("XMEM_WEIGHTS", raising=False)
    for seg in (TTR.segment_video, JTR.segment_video):
        with pytest.raises(FileNotFoundError, match="checkpoint"):
            seg(np.zeros((2, 32, 32, 3), np.float32), np.zeros((32, 32)), backend="xmem")
    with pytest.raises(KeyError):
        TTR.segment_video(np.zeros((2, 8, 8, 3), np.float32), np.zeros((8, 8)), backend="sam")


def test_xmem_segment_video_matches_jax(tmp_path, monkeypatch):
    """A seeded XMem state dict (a narrow value / hidden width) written by the
    test, loaded by each package's xmem backend, one from ``weights=`` and
    one from ``$XMEM_WEIGHTS``: the same masks on the same frames."""
    from animate3d_tpu.tools.xmem_arch import XMemNet

    torch.manual_seed(0)
    path = tmp_path / "xmem.pth"
    torch.save(XMemNet(key_dim=16, value_dim=32, hidden_dim=8).state_dict(), path)
    rng = np.random.default_rng(1)
    frames = rng.uniform(size=(6, 40, 40, 3)).astype(np.float32)
    tmpl = np.zeros((40, 40), np.float32)
    tmpl[8:28, 10:30] = 1.0
    port = TTR.segment_video(frames, tmpl, backend="xmem", weights=str(path), device="cpu",
                             mem_every=2, max_memory=3)
    monkeypatch.setenv("XMEM_WEIGHTS", str(path))
    ref = JTR.segment_video(frames, tmpl, backend="xmem", mem_every=2, max_memory=3)
    assert port.shape == (6, 40, 40)
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(port[0], tmpl)


def _glb(path):
    raw = open(path, "rb").read()
    magic, version, total = struct.unpack("<III", raw[:12])
    assert magic == 0x46546C67 and version == 2 and total == len(raw)
    json_len = struct.unpack("<I", raw[12:16])[0]
    return json.loads(raw[20:20 + json_len]), raw[28 + json_len:]


def test_glb_morph_export_matches_jax(tmp_path):
    """The GLB against the JAX writer's on the same mesh and frames: the
    same glTF but for the generator name, the same binary buffer; and the
    inverse asset transform."""
    from animate3d_tpu_torch.gaussians.ply import asset_transform_matrix

    verts = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    faces = np.asarray([[0, 1, 2]], np.int32)
    frames = np.stack([verts, verts + [0, 0, 0.5], verts - [0.25, 0, 0]])
    port, port_bin = _glb(TX.write_glb_morph_animation(str(tmp_path / "a.glb"), verts, faces,
                                                       frames))
    ref, ref_bin = _glb(JX.write_glb_morph_animation(str(tmp_path / "b.glb"), verts, faces,
                                                     frames))
    assert len(port["meshes"][0]["primitives"][0]["targets"]) == 3
    assert port["animations"][0]["channels"][0]["target"]["path"] == "weights"
    port["asset"].pop("generator"), ref["asset"].pop("generator")
    assert port == ref and port_bin == ref_bin
    rot = asset_transform_matrix(90.0, 30.0)
    posed = np.einsum("ij,fnj->fni", rot, frames) * 2.0
    np.testing.assert_allclose(TX.inverse_asset_transform(posed, 90.0, 30.0, 2.0), frames,
                               atol=1e-5)
    np.testing.assert_array_equal(TX.inverse_asset_transform(posed, 90.0, 30.0, 2.0),
                                  JX.inverse_asset_transform(posed, 90.0, 30.0, 2.0))


def test_trajectory_loader(tmp_path):
    for i in [0, 1, 10, 2]:
        np.save(tmp_path / f"means3D_frame_{i}.npy", np.full((4, 3), float(i), np.float32))
    traj = TX.load_trajectory_frames(str(tmp_path))
    assert traj.shape == (4, 4, 3)
    np.testing.assert_array_equal(traj[:, 0, 0], [0, 1, 2, 10])


def test_mesh_chain_on_cpu(tmp_path):
    """The mesh-animation flow end to end on the CPU at 32² with a 10 x 20
    vertex sphere: every tool through its CLI entry point, the static render
    and the recon through ``cli/launch.py`` with the shipped yamls (overrides
    for the paths, the size and 3 steps). The tracked masks cover the
    object's rendered alpha (>= 0.95 of its pixels, <= 0.01 of the rest);
    the GLB has the mesh's vertex count and 16 morph targets."""
    from animate3d_tpu_torch.cli.launch import main as launch
    from animate3d_tpu_torch.data.cameras import fixed_view_cameras, gs_cameras_from_batch
    from animate3d_tpu_torch.gaussians.ply import load_gaussians
    from animate3d_tpu_torch.rendering.renderer4d import Renderer4DConfig, render_batch
    from animate3d_tpu_torch.tools import export_animated_mesh, mesh2gaussian, split_gif, tracking
    from animate3d_tpu_torch.utils.saving import export_to_gif_mv

    res, n_frames, tmp = 32, 16, str(tmp_path)
    obj = write_textured_sphere(os.path.join(tmp, "mesh"), 10, 20)
    mesh2gaussian.main(["--input_obj", obj, "--output_dir", f"{tmp}/data",
                        "--output_name", "asset"])
    static = launch(["--config", "configs/animate3d/visualize_four_view_static.yaml", "--test",
                     "--device", "cpu", f"system.geometry.geometry_convert_from={tmp}/data/asset.ply",
                     f"exp_root_dir={tmp}/out", f"data.height={res}", f"data.width={res}"])
    templates = os.path.join(static["trial_dir"], "save", "images")
    assert sorted(os.listdir(templates)) == [f"{v}.png" for v in range(4)]

    g = load_gaussians(f"{tmp}/data/asset.ply", 90.0, 0.0, 1.0)
    amp = 0.03 * torch.randn((3, 3), generator=torch.Generator().manual_seed(1))
    disp = torch.linspace(0, 1, n_frames)[:, None, None] * torch.sin(g.xyz @ (6.0 * amp))
    cams = fixed_view_cameras(height=res, width=res, total_frame=n_frames)
    b, n = 4 * n_frames, g.num_points
    frame = torch.arange(b) % n_frames
    with torch.no_grad():
        out = render_batch(g, lambda _: (g.xyz + disp[frame], g.get_rotation().expand(b, n, 4),
                                         g.get_scaling().expand(b, n, 3)),
                           gs_cameras_from_batch(cams, device="cpu"),
                           torch.as_tensor(cams["timestamps"]),
                           Renderer4DConfig(height=res, width=res, back_ground_color=(1, 1, 1)),
                           do_reconstruction=False)
    gif = export_to_gif_mv(out.rgb.reshape(4, n_frames, res, res, 3).numpy(), f"{tmp}/v.gif")
    split_gif.main(["--gif_path", gif, "--output_dir", f"{tmp}/frames"])
    tracking.main(["--frames_dir", f"{tmp}/frames", "--template_dir", templates,
                   "--output_dir", f"{tmp}/tracked", "--device", "cpu"])
    tracked = np.stack([np.asarray(Image.open(f"{tmp}/tracked/{k}.png"))[..., 3]
                        for k in range(b)]) > 127
    inside = out.alpha.numpy() > 0.5
    assert tracked[inside].mean() >= 0.95 and tracked[~inside].mean() <= 0.01

    args = ["--config", "configs/animate3d/mesh_animation_frame_16.yaml", "--device", "cpu",
            "system.prompt_processor.prompt=a toy", f"data.image_root={tmp}/tracked",
            f"system.geometry.geometry_convert_from={tmp}/data/asset.ply",
            f"system.connected_vertices_info_path={tmp}/data/asset.json",
            f"exp_root_dir={tmp}/out", f"data.height={res}", f"data.width={res}"]
    rec = launch(args[:2] + ["--train"] + args[2:] + ["trainer.max_steps=3"])
    assert len(rec["metrics"]) >= 1 and np.isfinite([m["loss"] for m in rec["metrics"]]).all()
    assert rec["system"].mesh_nn_idx is not None  # mesh-edge ARAP
    exp = launch(args[:2] + ["--export"] + args[2:])
    glb = export_animated_mesh.run(obj, os.path.join(exp["trial_dir"], "save",
                                                     "gaussian_trajectory"), f"{tmp}/anim.fbx")
    assert glb.endswith(".glb")
    gltf, _ = _glb(glb)
    prim = gltf["meshes"][0]["primitives"][0]
    assert gltf["accessors"][prim["attributes"]["POSITION"]]["count"] == n == 200
    assert len(prim["targets"]) == n_frames
