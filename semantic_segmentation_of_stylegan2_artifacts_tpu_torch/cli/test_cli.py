"""Evaluation of a best checkpoint on the card:

    python -m semantic_segmentation_of_stylegan2_artifacts_tpu_torch.cli.test_cli \\
        --cfg config.yaml --check_point_dir <dir or file> --out_dir <dir> [--device cuda]

Counterpart of the JAX package's ``cli/test_cli.py`` (reference
``test.py:36-224``): copies ``--cfg`` to ``config_used.yaml`` in
``--out_dir``, loads the best checkpoint (in a directory, as the JAX test
CLI: a JAX ``best_model.msgpack`` first, then ``best_model.pth``, then a
``best_model.orbax`` directory of either package; or the file itself, or
the directory itself when it is an orbax checkpoint), runs the metric pass over
the split with ``TEST.SIG_THRESHOLD`` (the 7 CSVs and ``log.txt`` in
``--out_dir``), and exports per-case PNGs under ``predictions/`` with the
reference's test-side binary threshold 0.4 (``test.py:206``), the image
copied beside them.  ``--tile`` evaluates full-size images through a model
built at the tile size by sliding-window inference.
"""

from __future__ import annotations

import argparse
import os
import random
import shutil

import numpy as np
import torch


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", type=str, required=True, metavar="FILE")
    parser.add_argument("--check_point_dir", type=str, required=True,
                        help="dir or file holding the best checkpoint")
    parser.add_argument("--out_dir", type=str, required=True)
    parser.add_argument("--split", type=str, default="test")
    parser.add_argument("--tile", type=int, default=0,
                        help="evaluate full-size images through a model of this "
                             "native size via sliding-window inference")
    parser.add_argument("--tile_overlap", type=float, default=0.5)
    parser.add_argument("--device", type=str, default="cuda")
    return parser


def main(argv=None):
    from ..core.config import get_config
    from ..data.dataset import SegArtifactDataset
    from ..data.pipeline import EvalLoader
    from ..metrics.csv_logger import CSVHandler
    from ..metrics.segmentation import (
        MetricsAggregator,
        case_metrics,
        case_metrics_multiclass,
        metrics_to_host,
        to_case_metrics,
    )
    from ..models.msunet import MSUNet
    from ..train.checkpoint import TEST_ORDER, load_best_state_dict
    from ..train.inference import tiled_predict
    from ..train.state import make_eval_step, make_predict_step
    from ..train.trainer import validate
    from ..viz.maps import create_bin_heat_mask_from_list, export_class_maps
    from .run_dir import close_logger, file_logger, tensorboard_writer

    args = build_arg_parser().parse_args(argv)
    config = get_config(args, False, True)
    num_classes = int(config.MODEL.NUM_CLASSES)
    threshold = float(config.TEST.SIG_THRESHOLD)
    os.makedirs(args.out_dir, exist_ok=True)
    shutil.copy(args.cfg, os.path.join(args.out_dir, "config_used.yaml"))
    log = file_logger("test", args.out_dir)
    try:
        seed = int(config.SEED)
        random.seed(seed)
        np.random.seed(seed)
        torch.manual_seed(seed)

        img_size = config.DATA.IMG_SIZE
        model = MSUNet.from_config(config, img_size=args.tile or img_size,
                                   device=args.device)
        model.ms_unet.load_state_dict(
            load_best_state_dict(args.check_point_dir, TEST_ORDER), strict=True)
        loader = EvalLoader(SegArtifactDataset(config.DATA.DATA_PATH, config.LIST_DIR,
                                               args.split),
                            img_size=img_size, num_classes=num_classes)
        with CSVHandler(args.out_dir) as csv_handler:
            if args.tile:
                predict_step = make_predict_step(model, num_classes=num_classes,
                                                 device=args.device)
                per_case = case_metrics if num_classes <= 1 else case_metrics_multiclass
                agg = MetricsAggregator()
                output_saver = []
                for batch in loader:
                    probs = tiled_predict(predict_step, batch["image"][0], tile=args.tile,
                                          overlap=args.tile_overlap)
                    m = per_case(torch.from_numpy(probs),
                                 torch.from_numpy(batch["label"][0]), threshold)
                    agg.add(to_case_metrics(batch["case_name"][0], metrics_to_host(m),
                                            float("nan")))
                    output_saver.append((batch["case_name"][0], probs))
                summary = agg.summarize(epoch=0)
                csv_handler.write_epoch(summary)
                mean_dice, score, fpr = summary.mean_soft_dice, summary.score, summary.mean_fpr
            else:
                eval_step = make_eval_step(
                    model, float(config.TRAIN.TVERSKY_LOSS_ALPHA),
                    float(config.TRAIN.TVERSKY_LOSS_BETA),
                    float(config.TRAIN.LOSS_TVERSKY_BCE_MIX), num_classes=num_classes,
                    per_sample=True, device=args.device)
                mean_dice, output_saver, score, fpr, _ = validate(
                    eval_step, loader, epoch=0, sig_threshold=threshold,
                    output_num=len(loader), logger=log, csv_handler=csv_handler,
                    num_classes=num_classes, collapse_probs=False)

        pred_dir = os.path.join(args.out_dir, "predictions")
        if num_classes > 1:
            # per-pixel argmax class maps, then the binary-style exports of
            # the max-over-classes probability
            export_class_maps([(c, p) for c, p in output_saver if p.ndim == 3], pred_dir,
                              bg_threshold=threshold)
            output_saver = [(c, p.max(axis=-1) if p.ndim == 3 else p)
                            for c, p in output_saver]
        # the reference exports binary masks at 0.4 here (test.py:206) and a
        # copy of each image (test.py:209)
        create_bin_heat_mask_from_list(output_saver, pred_dir, config.DATA.DATA_PATH,
                                       threshold=0.4, include_original=True)
        log.info(f"TEST mean_dice={mean_dice:.5f} Score={score:.5f} FPR={fpr:.5f}")
        writer = tensorboard_writer(os.path.join(args.out_dir, "log"))
        if writer is not None:  # reference test.py:173-175
            for name, value in (("mean_dice", mean_dice), ("Score", score), ("FPR", fpr)):
                writer.add_scalar(f"test/{name}", value, 0)
            writer.close()
    finally:
        close_logger(log)
    print(f"mean_soft_dice {mean_dice:.5f} Score {score:.5f} FPR {fpr:.5f}")
    return mean_dice, score, fpr


if __name__ == "__main__":
    main()
