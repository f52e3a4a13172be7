"""Plain float32 Dynamic loss, AdamW and train steps, and the predict maps.

The Dynamic loss (reference ``loss/DynamicLoss.py``): per image, the mean
binary cross-entropy with logits, mixed ``(1 - mix) * bce + mix * (1 - TI)``
with the Tversky index ``TI = (TP + s) / (TP + a FP + b FN + s)`` where the
mask has a foreground pixel; the batch mean of those.

AdamW as ``torch.optim.AdamW`` defines it (decoupled decay ``p *= 1 - lr wd``,
bias-corrected moments, ``eps`` outside the square root), over two groups:
decayed are the parameters of more than one dimension whose name holds no
"norm" and that are no bias.  A parameter the loss does not reach (the last
stage of each cent decoder) takes a zero gradient, so it is decayed.

Noise seeds: a step's micro-batch draws its masks from a generator seeded
with ``SeedSequence([seed, step, micro] + [rank if rank])``, the data rank
folded in for ranks other than 0.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from .msunet import Arch, Net, Noise, Numerics


def dynamic_loss_per_image(logits: torch.Tensor, target_u8: torch.Tensor, alpha: float,
                           beta: float, mix: float, smooth: float = 1e-6) -> torch.Tensor:
    """``(B,)`` losses of ``(B, H, W, 1)`` logits against ``(B, H, W)`` uint8
    masks (0 / 255)."""
    x = logits[..., 0].reshape(logits.shape[0], -1)
    y = (target_u8.reshape(target_u8.shape[0], -1).float() > 127.5).float()
    bce = (x.clamp(min=0) - x * y + torch.log1p(torch.exp(-x.abs()))).mean(1)
    p = torch.sigmoid(x)
    tp, fp, fn = (p * y).sum(1), (p * (1 - y)).sum(1), ((1 - p) * y).sum(1)
    tversky = 1 - (tp + smooth) / (tp + alpha * fp + beta * fn + smooth)
    return torch.where(y.sum(1) != 0, (1 - mix) * bce + mix * tversky, bce)


def noise_seed(seed: int, step: int, micro: int = 0, rank: int = 0) -> int:
    entropy = [seed, step, micro] + ([rank] if rank else [])
    return int(np.random.SeedSequence(entropy).generate_state(1)[0])


def decayed(name: str, shape: Sequence[int]) -> bool:
    return len(shape) > 1 and "norm" not in name.lower() and name.rsplit(".", 1)[-1] != "bias"


class AdamW:
    def __init__(self, params: Dict[str, torch.Tensor], betas, eps: float,
                 weight_decay: float):
        self.b1, self.b2 = (float(b) for b in betas)
        self.eps, self.wd = float(eps), float(weight_decay)
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             lr: float) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for n, p in params.items():
            g = grads[n]
            if decayed(n, p.shape):
                p.mul_(1 - lr * self.wd)
            self.m[n].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[n] / c2).sqrt() + self.eps
            p.sub_(lr * (self.m[n] / c1) / denom)


def images_f32(images_u8: torch.Tensor) -> torch.Tensor:
    return images_u8.float() / 255.0


def train_readings(arch: Arch, params: Dict[str, torch.Tensor], batches: List[tuple],
                   *, lr: float, seed: int, ranks: int, loss_abc: tuple, betas, eps: float,
                   weight_decay: float, numerics: Numerics = Numerics(),
                   rows_per_pass: int = 1) -> dict:
    """Run ``len(batches)`` train steps from ``params`` (changed in place) and
    return what the benchmark compares: each step's loss, each leaf's norm
    of the first step's gradient, and each leaf's norm of the change after
    the last step.  ``batches[k]`` is ``(images_u8, masks_u8)`` of step k's
    whole batch, on the device, its rows split in ``ranks`` contiguous shards
    (data ranks, each drawing its own noise); the loss and the gradient are
    the mean over the shards, as data-parallel training makes them.  Each
    shard runs ``rows_per_pass`` rows at a time (its noise drawn whole each
    time), so the reference fits on the card."""
    start = {n: p.detach().clone() for n, p in params.items()}
    for p in params.values():
        p.requires_grad_(True)
    net = Net(arch, params, numerics)
    opt = AdamW(params, betas, eps, weight_decay)
    dev = next(iter(params.values())).device
    losses, grad_norms = [], None
    for step, (images, masks) in enumerate(batches):
        grads = {n: torch.zeros_like(p) for n, p in params.items()}
        total = 0.0
        shard = images.shape[0] // ranks
        for r in range(ranks):
            g = torch.Generator(device=dev)
            state = g.manual_seed(noise_seed(seed, step, 0, r)).get_state()
            for lo in range(0, shard, rows_per_pass):
                rows = slice(lo, min(lo + rows_per_pass, shard))
                g.set_state(state)
                sl = slice(r * shard + rows.start, r * shard + rows.stop)
                logits = net.forward(images_f32(images[sl]), Noise(g, shard, rows))
                per = dynamic_loss_per_image(logits, masks[sl], *loss_abc)
                loss = per.sum() / (shard * ranks)
                named = [(n, p) for n, p in params.items()]
                got = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
                for (n, _), gr in zip(named, got):
                    if gr is not None:
                        grads[n] += gr
                total += float(loss.detach())
                del logits, per, loss, got
        losses.append(total)
        if grad_norms is None:
            grad_norms = {n: float(g.norm()) for n, g in grads.items()}
        opt.step(params, grads, lr)
        del grads
    change = {n: float((params[n].detach() - start[n]).norm()) for n in params}
    return {"loss": losses, "grad_norm": grad_norms, "change_norm": change}


@torch.no_grad()
def predict_maps(arch: Arch, params: Dict[str, torch.Tensor], images_u8: torch.Tensor,
                 numerics: Numerics = Numerics(), rows_per_pass: int = 1) -> torch.Tensor:
    """``(B, H, W)`` float32 probabilities (sigmoid of the logit) in eval mode."""
    net = Net(arch, params, numerics)
    out = []
    for lo in range(0, images_u8.shape[0], rows_per_pass):
        x = images_f32(images_u8[lo:lo + rows_per_pass])
        out.append(torch.sigmoid(net.forward(x, Noise(None, x.shape[0]))[..., 0]))
    return torch.cat(out)
