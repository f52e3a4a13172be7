"""Label-free batch inference on the card:

    python -m semantic_segmentation_of_stylegan2_artifacts_tpu_torch.cli.predict_cli \\
        --cfg config.yaml --check_point_dir <dir or file> --out_dir <dir> [--device cuda]

Counterpart of the JAX package's ``cli/predict_cli.py`` with the same
arguments (plus ``--device``): runs the model over a split and writes
per-case grey heatmaps, binary masks, colour heatmaps and contour
overlays under the same file names, and with ``MODEL.NUM_CLASSES > 1`` an
argmax class map per case.  ``--tile`` runs sliding-window inference with a
model built at the tile size.  The checkpoint is a reference-layout
``.pth``, a JAX ``.msgpack`` or an orbax checkpoint directory, or a
directory holding ``best_model.pth``, ``best_model.msgpack`` or
``best_model.orbax`` (in that order); it loads with ``strict=True``.
"""

from __future__ import annotations

import argparse
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


def main(argv=None):
    from ..core.config import get_config
    from ..data.dataset import SegArtifactNoLabelDataset
    from ..data.pipeline import EvalLoader
    from ..models.msunet import MSUNet
    from ..train.checkpoint import load_best_state_dict
    from ..train.inference import artifact_prediction, tiled_predict
    from ..train.state import make_predict_step
    from ..viz.maps import create_bin_heat_mask_from_list, export_class_maps
    from .run_dir import close_logger, file_logger

    args = build_arg_parser().parse_args(argv)
    config = get_config(args, False, True)
    num_classes = int(config.MODEL.NUM_CLASSES)
    os.makedirs(args.out_dir, exist_ok=True)
    log = file_logger("predict", args.out_dir)
    try:
        img_size = config.DATA.IMG_SIZE
        model = MSUNet.from_config(config, img_size=args.tile or img_size,
                                   device=args.device)
        model.ms_unet.load_state_dict(load_best_state_dict(args.check_point_dir),
                                      strict=True)

        ds = SegArtifactNoLabelDataset(config.DATA.DATA_PATH, config.LIST_DIR, args.split)
        loader = EvalLoader(ds, img_size=img_size, num_classes=num_classes)
        predict_step = make_predict_step(model, num_classes=num_classes, device=args.device)
        if args.tile:
            preds = [(batch["case_name"][0],
                      tiled_predict(predict_step, batch["image"][0], tile=args.tile,
                                    overlap=args.tile_overlap))
                     for batch in loader]
        else:
            preds = artifact_prediction(predict_step, loader)

        if num_classes > 1:
            # argmax class maps, then the binary-style exports of the
            # max-over-classes probability (as the test CLI)
            export_class_maps([(c, p) for c, p in preds if p.ndim == 3], args.out_dir,
                              bg_threshold=float(args.threshold))
            preds = [(c, p.max(axis=-1) if p.ndim == 3 else p) for c, p in preds]
        written = create_bin_heat_mask_from_list(
            preds, args.out_dir, config.DATA.DATA_PATH, threshold=float(args.threshold))
        log.info(f"predicted {len(preds)} cases, wrote {len(written)} files")
    finally:
        close_logger(log)
    print(f"predicted {len(preds)} cases -> {args.out_dir}")
    return preds


if __name__ == "__main__":
    main()
