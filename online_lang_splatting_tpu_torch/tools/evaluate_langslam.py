"""2D language evaluation of the one-stage pipeline: mIoU and localization
accuracy (port of eval/evaluate_langslam.py): the protocol of
`evaluate_onlinelangslam`, decoding 15 -> 768 directly through the offline
autoencoder.

    python -m online_lang_splatting_tpu_torch.tools.evaluate_langslam \
        --feat-dir run/before_opt/lang --ann ann.json --weights-dir <npz dir> [--device cuda]
"""

from __future__ import annotations

from .evaluate_onlinelangslam import main as _main


def main(argv=None) -> dict:
    return _main(argv, single_stage=True)


if __name__ == "__main__":
    main()
