"""An architecture that lives with the tests: the MS-UNet with one more
leaf, a learned gain on the logits, drawn and decayed by rules of its own,
and with counts and spans of its own.  A configuration names it by its
dotted module name under ``"reference"``; ``test_bench_architecture.py``
runs it through the harness's consumers without an edit to any of them."""

from benchmark import weights
from benchmark.reference import msunet
from benchmark.reference.msunet import Arch, Noise, Numerics  # noqa: F401

GAIN = "ms_unet.output_gain"

SPANS = {"Linear": "bench.attn", "Conv2d": "bench.head"}


def param_shapes(arch):
    return msunet.param_shapes(arch) + [(GAIN, (1,))]


class Net(msunet.Net):
    def forward(self, images, noise):
        return super().forward(images, noise) * self.P[GAIN]


def draw_leaf(name, shape, normal, uniform):
    """The gain uniform in [1, 3); the MS-UNet's rule elsewhere."""
    if name == GAIN:
        return 2.0 + uniform
    return weights.draw_leaf(name, shape, normal, uniform)


def decayed(name, shape):
    """Only the gain decays."""
    return name == GAIN


def forward_flops(config, batch):
    return 1.0e9 * batch


def attention_ms(config, batch, train):
    return (3.0 if train else 1.0) * 1e-3 * batch


def head_ms(config, batch, train):
    return (3.0 if train else 1.0) * 2e-3 * batch
