"""Data parallelism with a frozen encoder and one staged unfreeze: the
port's DDP steps over two ``gloo`` ranks against the JAX package's steps
over a 2-device mesh and against the port's steps in one process, on the
CPU (the model, batches and tolerances of ``tests/test_torch_parallel.py``).

The encoder starts frozen (stages 0-3 and the patch embedding); stage 3
unfreezes before the second step.  JAX rebuilds its optimizer
(``build_optimizer`` + ``carry_opt_state``); the port adds the stage to
AdamW (``train/optim.py::unfreeze``) and rebuilds the DDP wrapper, without
which the new stage would never be all-reduced.

Against JAX: both steps' losses to 1e-5, and every parameter but stage 3's
to the tolerances of ``test_torch_parallel.py``.  Stage 3 is held to
Adam's bound only: its first update after the unfreeze differs by design.
The port gives a new stage a fresh per-parameter Adam step, as the
reference's ``add_param_group`` does; JAX carries optax's one global count,
so its first update of the stage is bias-corrected at count 2 (about 0.74
lr where the port moves lr).  Against the port in one process: every
parameter, stage 3 included, to the same tolerances.  The frozen stages
and the patch embedding never move, and stage 3 does.
"""

import numpy as np

from test_torch_parallel import (  # noqa: F401  (fixtures)
    LR,
    _batches,
    _flat,
    _one_thread,
    assert_params_close,
    cfg_path,
    jax_init,
    jax_mesh_steps,
    spawn_ranks,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.weights import (
    flax_to_state_dict,
    state_dict_to_flax,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.tools import dp_check

FROZEN = (0, 1, 2, 3)
UNFREEZE = {1: (0, 1, 2)}


def test_ddp_unfreeze_matches_jax_mesh_and_one_process(cfg_path, jax_init, tmp_path):
    batches = _batches(2, seed=3)
    want, want_losses = jax_mesh_steps(jax_init, batches, frozen=FROZEN, unfreeze=UNFREEZE)
    spec, got = spawn_ranks(cfg_path, jax_init, batches, tmp_path, frozen=FROZEN,
                            unfreeze=UNFREEZE)
    assert got["frozen"] == [0, 1, 2]
    np.testing.assert_allclose(got["losses"], want_losses, atol=1e-5, rtol=0)
    assert_params_close(got["state_dict"], want, steps=2, skip=("msunet/layers_3/",))
    ported = dict(_flat(state_dict_to_flax(got["state_dict"])))
    for k, w in _flat(want["msunet"]["layers_3"], ("msunet", "layers_3")):
        assert np.abs(ported[k] - w).max() <= 2 * LR * 2, "/".join(k)
    assert_params_close(got["state_dict"], state_dict_to_flax(
        dp_check.run_steps(spec)["state_dict"]), steps=2)

    init = dict(_flat(jax_init[2].params))
    for k, v in init.items():
        if k[1] in ("layers_0", "layers_1", "layers_2", "patch_embed"):
            np.testing.assert_array_equal(ported[k], v, err_msg="/".join(k))
    assert any(not np.array_equal(ported[k], v) for k, v in init.items()
               if k[1] == "layers_3")
    assert flax_to_state_dict(jax_init[2].params).keys() == got["state_dict"].keys()
