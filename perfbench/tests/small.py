"""Cells cut to a size the CPU runs in seconds, for the tests: the
smoke scene's 96 x 64 frames and short loops, a narrow extractor. The
production limits and everything else of the cell stay. `two_stage`
gives the orbit the configuration's other language codec: an extractor
whose autoencoder ends in 32 and the online 32 -> 15 codec."""

import copy

from perfbench.harness import common


def cell(workload: str, **traffic) -> dict:
    from online_lang_splatting_tpu_torch.slam.config import load_config

    c = copy.deepcopy(common.cell(common.manifest(), workload))
    c["config"]["extractor"].update(
        depths=[1, 1, 1, 1], dims=[8, 16, 32, 64], embed_dim=32, clip_dim=32,
        clip_resolution=[64, 64], ae_encoder=[16, 8, 15], ae_decoder=[8, 16, 32])
    smoke = load_config(common.ROOT / "configs" / "synthetic" / "smoke.yaml")
    if c["config"]["system"] == "slam":
        s = c["config"]["slam"]
        s["Dataset"]["Calibration"].update(smoke["Dataset"]["Calibration"], depth_scale=1000.0)
        s["Dataset"].update(pcd_downsample=8, pcd_downsample_init=4)
        s["Training"].update({k: smoke["Training"][k] for k in (
            "init_itr_num", "init_gaussian_update", "tracking_itr_num", "mapping_itr_num",
            "kf_interval", "window_size", "pose_window", "gaussian_update_every",
            "gaussian_update_offset")})
        s.update(capacity=4096, raster_tile=16)
    else:
        c["config"]["calibration"] = dict(smoke["Dataset"]["Calibration"])
    c["traffic"].update(traffic)
    return c


# The two numbers only two-stage runs compare have no cell and no limits
# file yet; these are the limits PERF.md proposes for such a cell, from
# the orbit's readings at published widths on the card.
TWO_STAGE_LIMITS = {"online_ae_step_err": 2e-4, "online_code_err": 1e-5}


def two_stage(clip: int = 64, **traffic) -> dict:
    """The orbit with the two-stage codec, its extractor's input `clip`
    pixels square; the codes come a quarter of that on a side."""
    c = cell("slam_replicav2_lang15.orbit", **traffic)
    c["config"]["slam"]["language"].update(single_stage=False, feat_hw=clip // 4)
    c["config"]["extractor"].update(clip_resolution=[clip, clip], ae_encoder=[16, 8, 32],
                                    ae_decoder=[8, 16, 32])
    c["limits"].update(TWO_STAGE_LIMITS)
    return c
