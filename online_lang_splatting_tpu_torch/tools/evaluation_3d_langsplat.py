"""3D semantic evaluation of LangSplat outputs (port of
tsdf-fusion/evaluation_3d_langsplat.py): `evaluation_3d` with the LangSplat
protocol, the LERF negatives included in the per-point semantic argmax
(the one-stage 15 -> 768 decode, no online codec).

    python -m online_lang_splatting_tpu_torch.tools.evaluation_3d_langsplat \
        --pred semantic_pc.ply --gt gt_pc.ply --classes "wall,chair" --weights-dir <npz dir>
"""

from __future__ import annotations

import sys

from .evaluation_3d import main as _main


def main(argv=None) -> dict:
    return _main([*(sys.argv[1:] if argv is None else argv), "--with-negatives"])


if __name__ == "__main__":
    main()
