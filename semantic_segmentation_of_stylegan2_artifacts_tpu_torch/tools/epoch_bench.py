"""End-to-end epoch throughput: host pipeline + train step on the card
(counterpart of the JAX package's ``tools/epoch_bench.py``).

Measures wall to wall what the reference's hot loop does (reference
``trainer.py:295-336``): PNG decode -> augmentation -> batch assembly
(``TrainLoader.epoch_batches_merged``) -> H2D from pinned memory
(``train/trainer.py::prefetch_to_device``) -> the train step of
``config.yaml``'s Swin-B with every kernel knob on.  Prints one JSON line
with the epoch's images/sec, the compute-only rate of the same step on a
resident batch, their ratio (``host_efficiency < 1`` shows pipeline
stalls), the host seconds a step waited for the loader, whether the loader
decoded natively (``native_decode``: ``native/``, off under
``SSA_TPU_NATIVE_DECODE=0``), the train steps run in all, and the device.
Host clocks are read after a device sync.

Usage::

    python -m semantic_segmentation_of_stylegan2_artifacts_tpu_torch.tools.epoch_bench \\
        [--img 512] [--n_fake 96] [--n_real 64] [--merge 4] [--workers 8] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import numpy as np
import torch


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--img", type=int, default=512)
    ap.add_argument("--n_fake", type=int, default=96)
    ap.add_argument("--n_real", type=int, default=64)
    ap.add_argument("--merge", type=int, default=4,
                    help="sampler pairs per device batch (batch = 2*merge)")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=2,
                    help="epoch 1 warms the allocator and kernels; later epochs are timed")
    ap.add_argument("--data_dir", default="",
                    help="existing synthetic root (default: generate)")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> dict:
    from ..core.config import default_config
    from ..core.device import resolve_device
    from ..data.dataset import SegArtifactDataset
    from ..data.pipeline import TrainLoader
    from ..data.synthetic import generate_synthetic_dataset
    from ..models.msunet import MSUNet
    from ..train.state import create_train_state, make_train_step
    from ..train.trainer import prefetch_to_device
    from .. import native

    args = build_arg_parser().parse_args(argv)
    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    root = args.data_dir
    if not root:
        root = tempfile.mkdtemp(prefix="epoch_bench_")
        t0 = time.time()
        generate_synthetic_dataset(root, img_size=args.img, n_fake_train=args.n_fake,
                                   n_real_train=args.n_real)
        print(f"synthetic dataset ({args.n_fake}f+{args.n_real}r @ "
              f"{args.img}^2): {time.time() - t0:.1f}s", file=sys.stderr)

    lists = f"{root}/lists"
    loader = TrainLoader(SegArtifactDataset(root, lists, "fake_train"),
                         SegArtifactDataset(root, lists, "real_train_all"),
                         img_size=args.img, seed=0, num_workers=args.workers)
    print(f"native decode: {native.available()}", file=sys.stderr)

    model = MSUNet(img_size=args.img, embed_dim=128, depths=(2, 2, 18, 2),
                   num_heads=(4, 8, 16, 32), window_size=7, dtype=torch.bfloat16,
                   softmax_dtype=torch.bfloat16, gelu_tanh=True, fused_head=True,
                   fused_attention=True, fused_patch=True)
    config = default_config()
    config.DATA.IMG_SIZE = args.img
    config.MODEL.FREEZE_ENCODER = False
    config.freeze()
    t0 = time.time()
    state = create_train_state(model, config, device=dev)
    print(f"init: {time.time() - t0:.1f}s", file=sys.stderr)
    step = make_train_step(model, 0.2, 0.8, 0.45)
    lr = 1e-4

    batch_size = 2 * args.merge
    epoch_rate = None
    wait_ms = None
    total_steps = 0
    for epoch in range(args.epochs):
        t0 = time.time()
        n_img = n_steps = 0
        wait = [0.0]
        loss = None
        for image, label in prefetch_to_device(
                loader.epoch_batches_merged(epoch, args.merge), dev,
                int(config.TPU.DEVICE_PREFETCH), wait):
            loss = step(state, image, label, lr)
            n_img += image.shape[0]
            n_steps += 1
        total_steps += n_steps
        final = float(loss)  # hard host sync
        sync()
        dt = time.time() - t0
        kind = "warmup" if epoch == 0 else "timed"
        print(f"epoch {epoch} ({kind}): {n_img} imgs in {dt:.1f}s = "
              f"{n_img / dt:.2f} img/s (loss {final:.4f}), loader wait "
              f"{1e3 * wait[0] / n_steps:.2f} ms/step", file=sys.stderr)
        if epoch > 0:
            epoch_rate = n_img / dt
            wait_ms = 1e3 * wait[0] / n_steps

    # compute-only rate on a resident batch, same step
    img_dev = torch.zeros((batch_size, args.img, args.img, 3), dtype=torch.uint8,
                          device=dev)
    lbl_dev = torch.zeros((batch_size, args.img, args.img), dtype=torch.uint8,
                          device=dev)
    warm, iters = 3, 20
    for _ in range(warm):
        loss = step(state, img_dev, lbl_dev, lr)
    float(loss)
    sync()
    t0 = time.time()
    for _ in range(iters):
        loss = step(state, img_dev, lbl_dev, lr)
    float(loss)
    sync()
    compute_rate = batch_size / ((time.time() - t0) / iters)
    total_steps += warm + iters

    result = {
        "metric": f"epoch_e2e_{args.img}sq_throughput",
        "value": round(epoch_rate, 3),
        "unit": "images/sec",
        "compute_only": round(compute_rate, 3),
        "host_efficiency": round(epoch_rate / compute_rate, 3),
        "native_decode": native.available(),
        "batch": batch_size,
        "steps": total_steps,
        "loader_wait_ms_per_step": round(wait_ms, 3),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
