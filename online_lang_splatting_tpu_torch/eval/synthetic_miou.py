"""End-to-end open-vocabulary mIoU on the synthetic scene (port of
eval/synthetic_miou.py).

Per-pixel class embeddings from the scene's exact ray-cast geometry take
the place of the SED/HR towers; everything after them is the port's own
path: the real AutoencoderMLP compression (768 -> 15, or 768 -> 32 plus
the online 32 -> 15 codec trained inside the SLAM loop), splat language
fusion through the blend kernels, eval_rendering's saved lang/{idx}.npy
maps, the (two-stage) decode, CLIPRelevancy and the LERF IoU and
localization scoring. The offline AE trains on the run's device on the
same numpy-seeded data stream as the JAX package's harness.
"""

from __future__ import annotations

import hashlib
import json
import time
from pathlib import Path

import numpy as np
import torch

from .relevancy import NEGATIVES, CLIPRelevancy


def _unit_rows(rng, n: int, d: int) -> np.ndarray:
    v = rng.normal(size=(n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _frame_key(img_hwc_255: np.ndarray) -> str:
    q = np.floor(np.asarray(img_hwc_255, np.float32) + 0.5).astype(np.uint8)
    return hashlib.md5(q.tobytes()).hexdigest()


def _nearest_resize_mask(mask: np.ndarray, hw) -> np.ndarray:
    h, w = mask.shape
    mh, mw = hw
    ys = np.minimum((np.arange(mh) * h) // mh, h - 1)
    xs = np.minimum((np.arange(mw) * w) // mw, w - 1)
    return mask[np.ix_(ys, xs)]


class SyntheticLangExtractor:
    """Drop-in `lang_extractor` whose 768-d features are class embeddings
    from the synthetic scene's geometry: `encode_frame(rgb_hwc_255) ->
    (H, W, code)` and `decode_codes((N, code)) -> (N, 768)` through a real
    AutoencoderMLP trained here on the embedding manifold (`stage=1`:
    768 -> 15; `stage=2`: 768 -> 32, leaving 32 -> 15 to the online
    codec)."""

    def __init__(self, dataset, *, lang_hw=(192, 192), clip_dim: int = 768,
                 stage: int = 1, seed: int = 0, train_steps: int = 300,
                 batch: int = 256, noise: float = 0.05, device="cuda"):
        from ..models.autoencoder import (ONE_STAGE_DEC, ONE_STAGE_ENC,
                                          TWO_STAGE_DEC, TWO_STAGE_ENC,
                                          AutoencoderMLP, make_offline_optimizer,
                                          offline_train_step)
        from ..models.init import make_generator

        if stage not in (1, 2):
            raise ValueError(f"stage must be 1 or 2, not {stage}")
        self.device = torch.device(device)
        self.labels = list(dataset.SEMANTIC_LABELS)
        self.lang_hw = tuple(lang_hw)
        self.clip_dim = clip_dim
        self.dataset = dataset
        rng = np.random.default_rng(seed)
        self.class_embeds = _unit_rows(rng, len(self.labels), clip_dim)
        self.neg_embeds = _unit_rows(rng, len(NEGATIVES), clip_dim)
        self._class_embeds_dev = torch.as_tensor(self.class_embeds, device=self.device)

        self._idx_of = {}
        for i in range(len(dataset)):
            img = np.transpose(np.asarray(dataset[i][0]), (1, 2, 0)).astype(np.float32)
            self._idx_of[_frame_key(img * np.float32(255.0))] = i

        enc, dec = ((ONE_STAGE_ENC, ONE_STAGE_DEC) if stage == 1
                    else (TWO_STAGE_ENC, TWO_STAGE_DEC))
        self.model = AutoencoderMLP(enc, dec, clip_dim,
                                    generator=make_generator(seed)).to(self.device)
        opt = make_offline_optimizer(self.model)
        base = np.concatenate([self.class_embeds, self.neg_embeds], axis=0)
        for _ in range(train_steps):
            # Noisy samples around each embedding plus pairwise blends:
            # rendered maps alpha-composite latents, so the decoder must be
            # faithful on mixtures, not only at the class points.
            idx = rng.integers(0, len(base), size=batch)
            jdx = rng.integers(0, len(base), size=batch)
            t = rng.uniform(0.0, 1.0, size=(batch, 1)).astype(np.float32)
            t = np.where(rng.uniform(size=(batch, 1)) < 0.5, 0.0, t)
            x = (1.0 - t) * base[idx] + t * base[jdx]
            x = x + rng.normal(size=(batch, clip_dim)) * noise
            x = x / np.linalg.norm(x, axis=-1, keepdims=True)
            offline_train_step(self.model, opt,
                               torch.as_tensor(x, dtype=torch.float32, device=self.device))
        self.model.requires_grad_(False)
        # Round-trip cosine on the class embeddings: the ceiling the
        # rendered maps can reach through this codec.
        with torch.no_grad():
            rec = self.model.decode(self.model.encode(self._class_embeds_dev))
            self.roundtrip_cos = float(torch.mean(torch.sum(rec * self._class_embeds_dev, -1)))

    def frame_index(self, rgb_hwc_255) -> int:
        if isinstance(rgb_hwc_255, torch.Tensor):
            rgb_hwc_255 = rgb_hwc_255.detach().cpu().numpy()
        key = _frame_key(rgb_hwc_255)
        if key not in self._idx_of:
            raise KeyError("frame not recognized: the extractor hashes the frames of "
                           "the dataset it was built with; pass the same config/seed")
        return self._idx_of[key]

    def class_map(self, idx: int, hw=None) -> np.ndarray:
        return _nearest_resize_mask(self.dataset.gt_semantics(idx), hw or self.lang_hw)

    @torch.no_grad()
    def encode_frame(self, rgb_hwc_255) -> torch.Tensor:
        small = torch.as_tensor(self.class_map(self.frame_index(rgb_hwc_255)),
                                dtype=torch.long, device=self.device)
        feats = self._class_embeds_dev[small]  # (mh, mw, clip_dim)
        codes = self.model.encode(feats.reshape(-1, self.clip_dim))
        return codes.reshape(small.shape[0], small.shape[1], -1)

    @torch.no_grad()
    def decode_codes(self, codes) -> torch.Tensor:
        return self.model.decode(torch.as_tensor(codes, dtype=torch.float32,
                                                 device=self.device))

    def relevancy(self) -> CLIPRelevancy:
        """A scorer whose 'text' embeddings are the synthetic class and
        negative embeddings, keyed by label name."""
        table = dict(zip(self.labels, self.class_embeds))
        table.update(zip(NEGATIVES, self.neg_embeds))
        return CLIPRelevancy(embed_table=table, device=self.device)


class OnlineDecoder:
    """`decode(z15) -> z32` over a trained OnlineAETrainer: the `online_ae`
    object decode_lang_map / evaluate_scene expect."""

    def __init__(self, trainer):
        self._trainer = trainer

    def decode(self, z):
        return self._trainer.decode(z)


def write_annotations(extractor, frame_indices, out_dir) -> Path:
    """Consolidated ann.json + mask .npy files (what
    lerf_eval.load_annotations reads) from the scene's exact geometry: per
    frame, one full-resolution mask and box per class present."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    anns = {}
    for idx in frame_indices:
        sem = extractor.dataset.gt_semantics(idx)
        frame = {}
        for ci, label in enumerate(extractor.labels):
            mask = sem == ci
            if not mask.any():
                continue
            rows, cols = np.where(mask)
            mask_file = f"mask_{idx:05d}_{label}.npy"
            np.save(out_dir / mask_file, mask)
            frame[label] = {"mask_file": mask_file,
                            "bboxes": [[int(cols.min()), int(rows.min()),
                                        int(cols.max()), int(rows.max())]]}
        anns[f"{idx:05d}"] = frame
    path = out_dir / "ann.json"
    path.write_text(json.dumps(anns))
    return path


def run_synthetic_miou(config, *, max_frames=None, every: int = 5, out_dir=None,
                       stage: int | None = None, train_steps: int = 300,
                       seed: int = 0, device="cuda", return_extractor: bool = False):
    """SLAM on the synthetic scene with class-embedding language
    supervision, then the rendered maps scored with the LERF eval. Returns
    evaluate_scene's dict plus the run's context (stage, frames, AE
    round-trip cosine, keyframes, online-AE steps, eval PSNR, wall and
    phase times); with `return_extractor`, (that dict, the extractor), so
    a caller can decode the maps the run left in `out_dir/miou/lang`.
    `stage` defaults to the config's language.single_stage."""
    import tempfile

    from ..models.checkpoints import OnlineAETrainer
    from ..slam import evaluation
    from ..slam.datasets import load_dataset
    from ..slam.system import SLAM
    from .lerf_eval import evaluate_scene, evaluate_scene_multilevel

    lang_cfg = config.setdefault("language", {})
    lang_cfg["language_train"] = True
    lang_cfg.setdefault("lang_code_size", 15)
    if stage is None:
        stage = 1 if lang_cfg.get("single_stage", True) else 2
    lang_cfg["single_stage"] = stage == 1
    fh = lang_cfg.get("feat_hw", 192)
    lang_hw = tuple(fh) if isinstance(fh, (list, tuple)) else (fh, fh)

    t0 = time.time()
    dataset = load_dataset(config)
    extractor = SyntheticLangExtractor(dataset, lang_hw=lang_hw, stage=stage, seed=seed,
                                       train_steps=train_steps, device=device)
    online_ae = OnlineAETrainer(device=device) if stage == 2 else None
    slam = SLAM(config, lang_extractor=extractor, online_ae=online_ae, device=device)
    t_setup = time.time()
    slam.run_single_thread(max_frames=max_frames)
    t_run = time.time()

    if out_dir is None:
        out_dir = tempfile.mkdtemp(prefix="ols_miou_")
    out_dir = Path(out_dir)
    metrics = evaluation.eval_rendering(slam, save_dir=out_dir, tag="miou", every=every)
    lang_dir = out_dir / "miou" / "lang"
    saved = sorted(int(p.stem) for p in lang_dir.glob("*.npy"))
    ann_path = write_annotations(extractor, saved, out_dir / "ann")

    h, w = dataset.height, dataset.width
    dec = OnlineDecoder(online_ae) if online_ae else None
    result = evaluate_scene(str(lang_dir), str(ann_path), extractor, extractor.relevancy(),
                            online_ae=dec, eval_size=(h, w))

    # The same maps through the LangSplat multilevel entry point (one level
    # here), so the run exercises both protocols end to end.
    def _decode_flat(flat):
        return extractor.decode_codes(dec.decode(flat) if dec is not None else flat)

    ml = evaluate_scene_multilevel([str(lang_dir)], str(ann_path), _decode_flat,
                                   extractor.relevancy(), eval_size=(h, w), hwc=False)
    result.update(
        stage=stage,
        frames_evaluated=len(saved),
        ae_roundtrip_cos=extractor.roundtrip_cos,
        keyframes=len(slam.frontend.kf_indices),
        online_ae_steps=online_ae.step_count if online_ae else 0,
        eval_psnr=metrics["mean_psnr"],
        setup_s=t_setup - t0, slam_s=t_run - t_setup, eval_s=time.time() - t_run,
        phase_times=dict(slam.phase_times),
        multilevel={k: ml[k] for k in ("miou", "localization_acc", "num_queries")},
    )
    return (result, extractor) if return_extractor else result
