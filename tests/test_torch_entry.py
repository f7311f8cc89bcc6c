"""The port's entry points on the CPU: `slam_torch.main --eval` on a small
Replica-v2 tree, threaded mode, the gate tool's row, LPIPS against the JAX
package (seeded random AlexNet weights, 64x96, 1e-5 relative), and the
thread safety of the blend launch counters."""

import ast
import json
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from torch_helpers import n, t

from online_lang_splatting_tpu.eval import lpips as jlpips
from online_lang_splatting_tpu_torch import convert
from online_lang_splatting_tpu_torch.eval import lpips
from online_lang_splatting_tpu_torch.ops.raster import tiled
from online_lang_splatting_tpu_torch.slam import backend, evaluation
from online_lang_splatting_tpu_torch.slam.config import load_config
from online_lang_splatting_tpu_torch.slam.datasets import SyntheticDataset
from online_lang_splatting_tpu_torch.slam.system import SLAM

SMOKE = "configs/synthetic/smoke.yaml"


def _fast(cfg, **training):
    """smoke.yaml at CPU speed: tile 16, short budgets."""
    cfg["raster_tile"] = 16
    cfg["Training"].update(dict(init_itr_num=15, mapping_itr_num=5, tracking_itr_num=10),
                           **training)
    return cfg


def test_lpips_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    x0 = rng.uniform(size=(3, 64, 96)).astype(np.float32)
    x1 = np.clip(x0 + rng.normal(size=x0.shape).astype(np.float32) * 0.1, 0, 1)
    jp = jlpips.init_params(np.random.default_rng(3))
    tp = lpips.init_params(np.random.default_rng(3), device="cpu")
    ref = float(jlpips.lpips(jp, jnp.asarray(x0), jnp.asarray(x1)))
    got = float(lpips.lpips(tp, t(x0), t(x1)))
    assert abs(got - ref) <= 1e-5 * max(1.0, abs(ref)), (got, ref)
    assert float(lpips.lpips(tp, t(x0), t(x0))) == 0.0
    # The same tree through convert and through the converter's npz layout.
    from_numpy = convert.lpips_from_numpy(
        {"convs": [(np.asarray(w), np.asarray(b)) for w, b in jp["convs"]],
         "lins": [np.asarray(w) for w in jp["lins"]]})
    sd = {}
    for k, (pos, (w, b)) in enumerate(zip((0, 3, 6, 8, 10), jp["convs"])):
        sd[f"net.slice{k + 1}.{pos}.weight"] = np.asarray(w)
        sd[f"net.slice{k + 1}.{pos}.bias"] = np.asarray(b)
    for k, w in enumerate(jp["lins"]):
        sd[f"lin{k}.model.1.weight"] = np.asarray(w)
    np.savez(tmp_path / "lpips_alex.npz", **sd)
    loaded = lpips.load_params(str(tmp_path / "lpips_alex.npz"), device="cpu")
    jloaded = jlpips.load_params(str(tmp_path / "lpips_alex.npz"))
    for tree in (from_numpy, loaded):
        for (w, b), (w2, b2) in zip(tree["convs"], tp["convs"]):
            assert torch.equal(w, w2) and torch.equal(b, b2)
        for w, w2 in zip(tree["lins"], tp["lins"]):
            assert torch.equal(w, w2)
    assert float(lpips.lpips(loaded, t(x0), t(x1))) == got
    assert abs(float(jlpips.lpips(jloaded, jnp.asarray(x0), jnp.asarray(x1))) - ref) < 1e-7


def test_eval_lpips_switch(tmp_path, monkeypatch):
    monkeypatch.delenv("OLS_LPIPS_WEIGHTS", raising=False)
    cfg = load_config(SMOKE)
    fn, name = evaluation.make_lpips(cfg, "cpu")
    assert name == "msssim_proxy"
    img = torch.rand((3, 64, 96), generator=torch.Generator().manual_seed(0))
    assert fn(img, img) < 1e-3
    params = lpips.init_params(np.random.default_rng(1), device="cpu")
    np.savez(tmp_path / "w.npz", **{
        **{f"features.{p}.weight": n(w) for p, (w, _) in zip((0, 3, 6, 8, 10), params["convs"])},
        **{f"features.{p}.bias": n(b) for p, (_, b) in zip((0, 3, 6, 8, 10), params["convs"])},
        **{f"lin{k}.weight": n(w) for k, w in enumerate(params["lins"])}})
    monkeypatch.setenv("OLS_LPIPS_WEIGHTS", str(tmp_path / "w.npz"))
    fn, name = evaluation.make_lpips(cfg, "cpu")
    assert name == "lpips_alex"
    other = torch.rand((3, 64, 96), generator=torch.Generator().manual_seed(1))
    assert fn(img, other) == float(lpips.lpips(params, img, other))


def test_threaded_mode_tracks_while_a_keyframe_is_in_flight():
    """tests/test_slam_threaded.py's checks of the JAX package, on the
    port."""
    # 30 mapping iterations keep a keyframe in flight well past the
    # frontend's 1/3 s throttle, however loaded the host.
    cfg = _fast(load_config(SMOKE), single_thread=False, tracking_itr_num=15,
                mapping_itr_num=30)
    slam = SLAM(cfg, device="cpu")
    slam.run(max_frames=8)
    assert len(slam.frontend.kf_indices) >= 1
    assert int(slam.backend.aux.active.sum()) > 100
    for cam in slam.frontend.cameras.values():
        assert np.isfinite(cam.t).all()
    assert slam.frontend.render_inputs is not None
    assert slam.tracked_while_kf_in_flight >= 1
    assert not [th for th in threading.enumerate() if th.name == "slam-backend"]


def test_threaded_backend_error_reaches_the_main_thread(monkeypatch):
    cfg = _fast(load_config(SMOKE), single_thread=False)
    calls = []
    real_map = backend.BackEnd.map

    def failing_map(self, *args, **kwargs):
        calls.append(1)
        if len(calls) > 1:
            raise FloatingPointError("mapping diverged")
        return real_map(self, *args, **kwargs)

    monkeypatch.setattr(backend.BackEnd, "map", failing_map)
    slam = SLAM(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="backend thread failed") as err:
        slam.run(max_frames=8)
    assert isinstance(err.value.__cause__, FloatingPointError)
    assert not [th for th in threading.enumerate() if th.name == "slam-backend"]


def test_use_gui_builds_the_headless_viewer(tmp_path):
    """use_gui: True on the CPU writes the headless viewer's mosaics; the
    interactive window needs open3d, and without it SLAM falls back to the
    headless viewer."""
    from online_lang_splatting_tpu_torch.gui.viewer import HeadlessViewer

    cfg = _fast(load_config(SMOKE))
    cfg["Results"]["use_gui"] = True
    slam = SLAM(cfg, device="cpu", save_dir=tmp_path)
    assert isinstance(slam.viewer, HeadlessViewer)
    slam.viewer.every = 1
    slam.run(max_frames=3)
    assert slam.viewer is None  # closed with the run
    frames = sorted(p.name for p in (tmp_path / "viewer").iterdir())
    assert frames == ["frame_00001.png", "frame_00002.png"]
    png = np.asarray(Image.open(tmp_path / "viewer" / frames[-1]))
    assert png.shape[0] == cfg["Dataset"]["Calibration"]["height"] and png.std() > 0
    with pytest.raises(ImportError):
        import open3d  # noqa: F401
    cfg["Results"]["use_gui"] = "interactive"
    slam = SLAM(cfg, device="cpu", save_dir=tmp_path / "interactive")
    assert isinstance(slam.viewer, HeadlessViewer)
    slam.close()


def test_mesh_devices_needs_as_many_cards(monkeypatch):
    """make_mesh(n) takes the first n cards and raises when fewer exist: a
    repeated device never stands in for a missing card."""
    from online_lang_splatting_tpu_torch.parallel.mesh import make_mesh, named_mesh

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = make_mesh(2)
    assert mesh.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert make_mesh().size == 2
    with pytest.raises(ValueError, match="4 cuda devices was asked for, 2 exist"):
        make_mesh(4)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="1 cuda devices was asked for, 0 exist"):
        make_mesh(1)
    with pytest.raises(ValueError, match="2 cpu devices"):
        make_mesh(2, device="cpu")
    cfg = load_config(SMOKE)
    cfg["mesh_devices"] = 2
    with pytest.raises(ValueError, match="2 cpu devices"):
        SLAM(cfg, device="cpu")
    assert named_mesh(["cpu"] * 3).size == 3  # named devices may repeat


def test_kernel_stats_count_from_many_threads():
    stats = tiled.KernelStats()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(c):
            for _ in range(2000):
                stats.count(c, plain=c % 2 == 0)

        threads = [threading.Thread(target=work, args=(c,)) for c in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert stats.launches == stats.plain_calls == 8 * 2000
    assert stats.launches_by_channels == {c: 2000 for c in range(1, 16, 2)}
    assert stats.plain_by_channels == {c: 2000 for c in range(0, 16, 2)}


def _replicav2_tree(root, cfg, frames):
    ds = SyntheticDataset(cfg)
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    lines = []
    for i in range(frames):
        color, depth, pose, _, _ = ds[i]
        Image.fromarray((color.transpose(1, 2, 0) * 255).round().astype(np.uint8)).save(
            root / "rgb" / f"rgb_{i}.png")
        Image.fromarray(np.clip(depth * 1000, 0, 65535).round().astype(np.uint16)).save(
            root / "depth" / f"depth_{i}.png")
        lines.append(" ".join(f"{v:.9f}" for v in pose.reshape(-1)))
    (root / "traj_w_c.txt").write_text("\n".join(lines) + "\n")


def test_slam_torch_eval_on_replicav2_tree(tmp_path):
    import slam_torch

    cfg = _fast(load_config(SMOKE), kf_interval=2)
    _replicav2_tree(tmp_path / "room", cfg, 6)
    cfg["Dataset"].update(type="replicav2", dataset_path=str(tmp_path / "room"))
    cfg["Dataset"]["Calibration"]["depth_scale"] = 1000.0
    cfg["Results"].update(save_dir=str(tmp_path / "results"), color_refinement_iters=4)
    cfg["language"]["language_train"] = False  # no extractor to build
    (tmp_path / "room.yaml").write_text(yaml.dump(cfg))
    tiled.FWD_STATS.reset()
    slam = slam_torch.main(["--config", str(tmp_path / "room.yaml"), "--eval", "--device", "cpu"])
    run = slam.save_dir
    names = {p.name for p in run.iterdir()}
    assert {"config.yml", "metrics_before_opt.json", "metrics_after_opt.json",
            "gaussians_final.ply", "gaussians_final_after_opt.ply"} <= names
    assert yaml.safe_load((run / "config.yml").read_text())["Results"]["eval_rendering"]
    for tag in ("before_opt", "after_opt"):
        m = json.loads((run / f"metrics_{tag}.json").read_text())
        assert m["tag"] == tag and m["lpips_metric"] == "msssim_proxy"
        assert np.isfinite(m["mean_psnr"]), m
        assert m == {k: v for k, v in slam.metrics[tag].items() if k != "ate_rmse"}
    assert type(slam.dataset._dataset).__name__ == "ReplicaV2Dataset"
    assert slam.phase_times["refine"] > 0
    assert tiled.FWD_STATS.plain_by_channels.get(19, 0) > 0  # refinement + eval renders


def test_gate_tool_row_has_the_jax_tools_keys(tmp_path, capsys):
    from online_lang_splatting_tpu_torch.tools import replica_scale_gate

    cfg = _fast(load_config(SMOKE))
    (tmp_path / "gate.yaml").write_text(yaml.dump(cfg))
    rc = replica_scale_gate.main(["--config", str(tmp_path / "gate.yaml"), "--max-frames", "8",
                                  "--device", "cpu", "--no-gates", "--tag", "cpu",
                                  "--out", str(tmp_path / "rows.jsonl")])
    assert rc == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row == json.loads((tmp_path / "rows.jsonl").read_text())
    # The keys of the JAX tool's `result` dict, read from its source.
    src = ast.parse(open("tools/replica_scale_gate.py").read())
    jax_keys = next(
        [k.value for k in node.value.keys]
        for node in ast.walk(src)
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "result")
    assert list(row) == jax_keys + ["device", "gates_ok"]
    assert row["blend_chunk"] is None and row["device"] == "cpu" and row["frames"] == 8
    assert row["keyframes"] >= 3 and np.isfinite(row["psnr"]) and np.isfinite(row["ate"])
