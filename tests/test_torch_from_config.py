"""``MSUNet.from_config`` takes the JAX package's positional order.

``(config, img_size, num_classes, dtype)`` in both packages (the port adds
``device`` after them): a positional third argument sets the class count
over the config's ``MODEL.NUM_CLASSES`` (1), and the logits' last axis of
the two models agrees.  CPU, a tiny float32 model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_of_stylegan2_artifacts_tpu.core.config import (
    load_config as jax_load_config,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu.models import MSUNet as JaxMSUNet
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.core.config import load_config
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.msunet import MSUNet

TINY_YAML = """DATA:
  IMG_SIZE: 32
MODEL:
  SWIN:
    EMBED_DIM: 16
    DEPTHS: [1, 1, 1, 1]
    NUM_HEADS: [2, 2, 2, 2]
    WINDOW_SIZE: 4
TPU:
  COMPUTE_DTYPE: float32
  FUSED_HEAD: false
"""


@pytest.mark.parametrize("num_classes", [2, 5])
def test_positional_num_classes_matches_jax(tmp_path, num_classes):
    path = tmp_path / "tiny.yaml"
    path.write_text(TINY_YAML)
    x = np.zeros((1, 32, 32, 3), np.float32)
    jm = JaxMSUNet.from_config(jax_load_config(str(path)), 32, num_classes)
    variables = jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), True)
    want = jm.apply(variables, jnp.asarray(x), True).shape
    model = MSUNet.from_config(load_config(str(path)), 32, num_classes, device="cpu")
    with torch.no_grad():
        got = tuple(model(torch.from_numpy(x)).shape)
    assert got[-1] == want[-1] == num_classes
    assert got == tuple(want)
