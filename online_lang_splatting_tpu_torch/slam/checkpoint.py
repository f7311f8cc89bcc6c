"""Mid-run SLAM snapshot and resume (port of slam/checkpoint.py).

The snapshot holds what continuing the run needs: the Gaussian map, its
Adam moments and aux state, the backend's iteration counter, every
keyframe's pose, exposure and cached language supervision, the keyframe
pose optimizer, window and visibility bookkeeping, the tracked poses, and
the online codec's parameters. Keys are the JAX package's, so a snapshot
the JAX package wrote loads here. The port adds its own keys for what the
JAX package keeps as a JAX PRNG key or not at all: `torch_rng` (the
backend's generator state) and `torch_online_ae_opt/*` (the online codec's
Adam), so a resume of the port's own snapshot continues exactly. Keyframe
frames are decoded again from the dataset on load; they are not stored.

    slam_torch.py --checkpoint-every 50 ...       # snapshot every 50 frames
    slam_torch.py --resume run/ckpt_000100.npz    # continue from a snapshot
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import online_ae_to_numpy, snapshot_from_numpy


def _put(out: dict, prefix: str, tree):
    """Flatten NamedTuples / tuples / dicts of tensors into npz keys."""
    if hasattr(tree, "_fields"):
        for k in tree._fields:
            _put(out, f"{prefix}/{k}", getattr(tree, k))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _put(out, f"{prefix}/{k}", v)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            _put(out, f"{prefix}/{i}", v)
    elif isinstance(tree, torch.Tensor):
        out[prefix] = tree.detach().cpu().numpy()
    else:
        out[prefix] = np.asarray(tree)


def save_state(slam, path, frame_idx: int):
    """Snapshot everything needed to continue the run at `frame_idx`."""
    be, fe = slam.backend, slam.frontend
    out: dict = {}
    _put(out, "params", be.params)
    _put(out, "opt", be.opt)
    _put(out, "aux", be.aux)
    if be.keyframe_optimizer_state is not None:
        _put(out, "kf_opt", be.keyframe_optimizer_state)
    out["torch_rng"] = be.generator.get_state().cpu().numpy()
    out["iteration_count"] = np.int64(be.iteration_count)
    out["frame_idx"] = np.int64(frame_idx)
    out["cap"] = np.int64(be.cap)
    kf = sorted(be.viewpoints)
    out["kf_indices"] = np.asarray(kf, np.int64)
    out["fe_kf_indices"] = np.asarray(fe.kf_indices, np.int64)
    out["window"] = np.asarray(be.current_window, np.int64)
    out["median_depth"] = np.float64(fe.median_depth)
    for i in kf:
        cam = be.viewpoints[i]
        out[f"cam/{i}/r"] = np.asarray(cam.r)
        out[f"cam/{i}/t"] = np.asarray(cam.t)
        out[f"cam/{i}/exposure"] = np.asarray([cam.exposure_a, cam.exposure_b])
        if cam.gt_lang_feat is not None:
            _put(out, f"cam/{i}/lang", cam.gt_lang_feat)
        if cam.coco_lang_feat is not None:
            _put(out, f"cam/{i}/coco", cam.coco_lang_feat)
    for i, occ in be.occ_aware_visibility.items():
        out[f"occ/{i}"] = np.asarray(occ)
    # Tracked poses, for the trajectory evaluation of the resumed run.
    for i, cam in fe.cameras.items():
        out[f"traj/{i}"] = np.concatenate([np.asarray(cam.r).reshape(-1), np.asarray(cam.t)])
    if be.online_ae is not None:
        ae = be.online_ae
        _put(out, "online_ae", online_ae_to_numpy(ae.model.state_dict()))
        _put(out, "torch_online_ae_opt", {"mu": ae.optimizer.mu, "nu": ae.optimizer.nu,
                                          "count": ae.optimizer.count,
                                          "steps": ae.step_count})
    np.savez_compressed(path, **out)
    return path


def load_state(slam, path) -> int:
    """Restore a snapshot of either package into a freshly built SLAM.
    Returns the frame index to resume from."""
    from .camera import Camera

    with np.load(path) as data:
        st = snapshot_from_numpy({k: data[k] for k in data.files}, slam.device)
    be, fe = slam.backend, slam.frontend
    be.cap = st["cap"]
    be.params, be.opt, be.aux = st["params"], st["opt"], st["aux"]
    if st["kf_opt"] is not None:
        be.keyframe_optimizer_state = st["kf_opt"]
    if st["torch_rng"] is not None:
        be.generator.set_state(st["torch_rng"])
    else:
        seed = int(slam.config.get("seed", 0))
        be.generator.manual_seed(seed)
        print(f"[checkpoint] {path} holds no torch generator state (a JAX package "
              f"snapshot); the backend's random draws restart from seed {seed}")
    be.iteration_count = st["iteration_count"]
    be.current_window = list(st["window"])
    fe.current_window = list(be.current_window)
    fe.kf_indices = list(st["fe_kf_indices"])
    fe.median_depth = st["median_depth"]

    for i in st["kf_indices"]:
        c = st["cams"][i]
        cam = Camera.from_dataset(slam.dataset, i, slam.device)
        cam.compute_grad_mask(slam.config)
        cam.update_rt(c["r"], c["t"])
        cam.exposure_a, cam.exposure_b = (float(v) for v in c["exposure"])
        if "lang" in c:
            cam.gt_lang_feat = torch.as_tensor(c["lang"], device=slam.device)
        if "coco" in c:
            cam.coco_lang_feat = torch.as_tensor(c["coco"], device=slam.device)
        be.viewpoints[i] = cam
        fe.cameras[i] = cam
        # The frame stack is rebuilt from the dataset.
        be.frame_stack.add(i, cam.image, cam.depth)
        if cam.gt_lang_feat is not None and tuple(cam.gt_lang_feat.shape) == (
                (be.lang_dim,) + be.lang_hw):
            be.frame_stack.set_lang(i, cam.gt_lang_feat)
        if cam.coco_lang_feat is not None:
            be.frame_stack.set_coco(i, cam.coco_lang_feat)
    be.occ_aware_visibility.update(st["occ"])
    for i, rt in st["traj"].items():
        if i in fe.cameras:
            continue
        # Tracked non-keyframes contribute only their pose: a pose-only
        # camera, with no frame decoded.
        ds = slam.dataset
        gt = np.asarray(ds.poses[i], np.float32)
        cam = Camera(uid=i, image=None, depth=None, r_gt=gt[:3, :3], t_gt=gt[:3, 3],
                     fx=ds.fx, fy=ds.fy, cx=ds.cx, cy=ds.cy, fovx=ds.fovx, fovy=ds.fovy,
                     height=ds.height, width=ds.width)
        cam.update_rt(rt[:9].reshape(3, 3), rt[9:])
        fe.cameras[i] = cam
    if be.online_ae is not None and st["online_ae"] is not None:
        ae = be.online_ae
        ae.model.load_state_dict(st["online_ae"])
        opt = st["torch_online_ae_opt"]
        if opt is not None:
            for dst, key in ((ae.optimizer.mu, "mu"), (ae.optimizer.nu, "nu")):
                for i, m in enumerate(dst):
                    m.copy_(torch.as_tensor(opt[key][str(i)]))
            ae.optimizer.count = int(opt["count"])
            ae.step_count = int(opt["steps"])
    be.initialized = True
    slam._sync_frontend_state()
    return st["frame_idx"]
