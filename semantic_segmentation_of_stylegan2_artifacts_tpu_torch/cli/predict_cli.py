"""Label-free batch inference on the card:

    python -m semantic_segmentation_of_stylegan2_artifacts_tpu_torch.cli.predict_cli \\
        --cfg config.yaml --check_point_dir <dir or .pth> --out_dir <dir> [--device cuda]

Counterpart of the JAX package's ``cli/predict_cli.py`` with the same
arguments (plus ``--device``): runs the model over a split and writes
per-case grey heatmaps, binary masks, colour heatmaps and contour
overlays under the same file names.  ``--tile`` runs sliding-window
inference with a model built at the tile size.  The checkpoint is a
reference-layout ``.pth`` (``best_model.pth`` inside a directory), loaded
natively with ``strict=True``; the JAX package's ``.msgpack`` checkpoints
and the multi-class class-map export are not ported yet.
"""

from __future__ import annotations

import argparse
import logging
import os


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--cfg", type=str, required=True)
    p.add_argument("--check_point_dir", type=str, required=True)
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--split", type=str, default="test")
    p.add_argument("--threshold", type=float, default=0.4)
    p.add_argument("--tile", type=int, default=0)
    p.add_argument("--tile_overlap", type=float, default=0.5)
    p.add_argument("--device", type=str, default="cuda")
    return p


def _checkpoint_path(ckpt: str) -> str:
    if os.path.isdir(ckpt):
        ckpt = os.path.join(ckpt, "best_model.pth")
    if not ckpt.endswith((".pth", ".pt")):
        raise NotImplementedError(
            f"{ckpt}: only reference-layout .pth checkpoints load in the port so far")
    return ckpt


def main(argv=None):
    from ..core.config import get_config
    from ..data.dataset import SegArtifactNoLabelDataset
    from ..data.pipeline import EvalLoader
    from ..models.msunet import MSUNet
    from ..models.weights import load_reference_checkpoint
    from ..train.inference import artifact_prediction, tiled_predict
    from ..train.state import make_predict_step
    from ..viz.maps import create_bin_heat_mask_from_list

    args = build_arg_parser().parse_args(argv)
    config = get_config(args, False, True)
    if int(config.MODEL.NUM_CLASSES) > 1:
        raise NotImplementedError("multi-class export is not ported yet")
    os.makedirs(args.out_dir, exist_ok=True)
    log = logging.getLogger("predict")
    log.setLevel(logging.INFO)
    handler = logging.FileHandler(os.path.join(args.out_dir, "log.txt"))
    handler.setFormatter(logging.Formatter("[%(asctime)s.%(msecs)03d] %(message)s",
                                           datefmt="%H:%M:%S"))
    log.addHandler(handler)
    try:
        img_size = config.DATA.IMG_SIZE
        model = MSUNet.from_config(config, img_size=args.tile or img_size,
                                   device=args.device)
        model.ms_unet.load_state_dict(
            load_reference_checkpoint(_checkpoint_path(args.check_point_dir)), strict=True)

        ds = SegArtifactNoLabelDataset(config.DATA.DATA_PATH, config.LIST_DIR, args.split)
        loader = EvalLoader(ds, img_size=img_size)
        predict_step = make_predict_step(model, device=args.device)
        if args.tile:
            preds = [(batch["case_name"][0],
                      tiled_predict(predict_step, batch["image"][0], tile=args.tile,
                                    overlap=args.tile_overlap))
                     for batch in loader]
        else:
            preds = artifact_prediction(predict_step, loader)

        written = create_bin_heat_mask_from_list(
            preds, args.out_dir, config.DATA.DATA_PATH, threshold=float(args.threshold))
        log.info(f"predicted {len(preds)} cases, wrote {len(written)} files")
    finally:
        log.removeHandler(handler)
        handler.close()
    print(f"predicted {len(preds)} cases -> {args.out_dir}")
    return preds


if __name__ == "__main__":
    main()
