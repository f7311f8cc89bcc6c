"""SED-style dense language feature extraction, the fused per-frame path
(port of models/sed.py): normalize -> resize to 768^2 -> ConvNeXt-L CLIP
tower -> HR head -> autoencoder encode, frame (H, W, 3) in [0, 255] ->
(192, 192, low_dim) codes. float32 by default; with `compute_dtype`
(torch.bfloat16) the tower and the HR head run in that dtype, their
weights cast once at construction, while the autoencoder stays float32 and
every public output is float32, as in the JAX package.

With no state dicts given, every model is drawn from one seeded
`torch.Generator` with the flax initializers' scales (models/init.py), so
the pipeline runs with random weights for tests and the chip smoke run.
Public outputs keep the JAX package's channel-last layouts.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .autoencoder import ONE_STAGE_DEC, ONE_STAGE_ENC, AutoencoderMLP
from .convnext_clip import (DEPTHS, DIMS, EMBED_DIM, ConvNeXtCLIPVisual,
                            normalize_image, resize_bilinear)
from .hr_net import HighResLanguageFeatureNet
from .init import make_generator

CLIP_RESOLUTION = (768, 768)


class LangFeatureExtractor:
    """The visual tower + HR head + AE encoder on one device."""

    def __init__(self, visual_state: dict | None = None,
                 hr_state: dict | None = None, ae_state: dict | None = None, *,
                 encoder_dims: Sequence[int] | None = None,
                 decoder_dims: Sequence[int] | None = None,
                 use_hr: bool = True, clip_resolution=None,
                 depths: Sequence[int] = DEPTHS, dims: Sequence[int] = DIMS,
                 embed_dim: int = EMBED_DIM, clip_dim: int = 768,
                 compute_dtype: torch.dtype | None = None, seed: int = 0, device="cuda"):
        self.device = torch.device(device)
        # bfloat16 halves the towers' weight and activation traffic; the
        # frame is cast before the 768^2 resize, so the towers run in it.
        self.compute_dtype = compute_dtype or torch.float32
        # SED resizes every frame to 768x768 before the dense encode;
        # overridable for small-scale tests.
        self.clip_resolution = tuple(clip_resolution or CLIP_RESOLUTION)
        gen = make_generator(seed)
        self.visual = ConvNeXtCLIPVisual(depths, dims, embed_dim, generator=gen)
        self.hr = (HighResLanguageFeatureNet(embed_dim, dims[1], dims[0], clip_dim,
                                             generator=gen) if use_hr else None)
        self.ae = AutoencoderMLP(tuple(encoder_dims or ONE_STAGE_ENC),
                                 tuple(decoder_dims or ONE_STAGE_DEC), clip_dim,
                                 generator=gen)
        for model, state in ((self.visual, visual_state), (self.hr, hr_state),
                             (self.ae, ae_state)):
            if model is not None and state is not None:
                model.load_state_dict(state)
        for model in (self.visual, self.hr, self.ae):
            if model is not None:
                model.to(self.device).eval().requires_grad_(False)
        for model in (self.visual, self.hr):
            if model is not None:
                model.to(self.compute_dtype)

    def _frame(self, rgb) -> torch.Tensor:
        rgb = torch.as_tensor(rgb, dtype=torch.float32, device=self.device)
        x = normalize_image(rgb).permute(2, 0, 1)[None].to(self.compute_dtype)
        return resize_bilinear(x, self.clip_resolution)

    def _hr_inner(self, rgb):
        feats = self.visual(self._frame(rgb))
        if self.hr is None:
            # The reference's hr_model=None path: the os32 dense CLIP map
            # supervises directly, no refinement.
            return feats["clip_vis_dense"], feats
        return self.hr(feats["clip_vis_dense"], feats["res3"], feats["res2"]), feats

    @torch.no_grad()
    def dense_clip(self, rgb) -> dict:
        """The reference's dense `get_lang_feat`: the pyramid, NHWC."""
        return {k: v.permute(0, 2, 3, 1).float()
                for k, v in self.visual(self._frame(rgb)).items()}

    @torch.no_grad()
    def hr_features(self, rgb) -> torch.Tensor:
        """(192, 192, 768) refined CLIP map (the reference hr_model output)."""
        return self._hr_inner(rgb)[0][0].permute(1, 2, 0).float()

    @torch.no_grad()
    def encode_frame(self, rgb) -> torch.Tensor:
        """(192, 192, low_dim): the online language supervision map."""
        hr, _ = self._hr_inner(rgb)
        _, c, h, w = hr.shape
        code = self.ae.encode(hr[0].permute(1, 2, 0).reshape(-1, c).float())
        return code.reshape(h, w, -1)

    @torch.no_grad()
    def decode_codes(self, codes) -> torch.Tensor:
        """(..., low_dim) -> (..., 768) through the AE decoder."""
        codes = torch.as_tensor(codes, dtype=torch.float32, device=self.device)
        out = self.ae.decode(codes.reshape(-1, codes.shape[-1]))
        return out.reshape(codes.shape[:-1] + (out.shape[-1],))
