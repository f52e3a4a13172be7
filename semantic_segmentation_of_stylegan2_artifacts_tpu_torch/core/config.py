"""Config system: a yacs-compatible frozen config-node tree.

The port's own copy of the JAX package's ``core/config.py`` (reference
``config.py:13-180``): the same schema, key names and defaults, YAML merge
with recursive BASE includes, freezing, and train/test flag validation.
``yaml`` is imported only where a file is read or written, so the model
and ``chip_smoke.py`` run without it.
"""

from __future__ import annotations

import copy
import os
import sys
from typing import Any, Dict, Optional


class CfgNode(dict):
    """A dict with attribute access, freezing, and type-checked merging.

    Minimal re-implementation of the yacs ``CfgNode`` semantics the
    reference relies on: attribute get/set, ``freeze``/``defrost``,
    ``merge_from_file`` (only existing keys, type-coerced), ``clone``,
    and YAML dump.
    """

    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict: Optional[Dict] = None):
        init_dict = init_dict or {}
        super().__init__()
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        for k, v in init_dict.items():
            if isinstance(v, dict):
                v = CfgNode(v)
            dict.__setitem__(self, k, v)

    # -- attribute access -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(f"Config has no attribute {name!r}")

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(
                f"Attempted to set {name} to {value}, but CfgNode is immutable"
            )
        self[name] = value

    def __setitem__(self, key, value):
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(
                f"Attempted to set {key} to {value}, but CfgNode is immutable"
            )
        dict.__setitem__(self, key, value)

    # -- freezing ---------------------------------------------------------
    def freeze(self) -> None:
        self._set_immutable(True)

    def defrost(self) -> None:
        self._set_immutable(False)

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, CfgNode.IMMUTABLE)

    def _set_immutable(self, value: bool) -> None:
        object.__setattr__(self, CfgNode.IMMUTABLE, value)
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_immutable(value)

    # -- merging ----------------------------------------------------------
    def clone(self) -> "CfgNode":
        node = CfgNode()
        for k, v in self.items():
            if isinstance(v, CfgNode):
                dict.__setitem__(node, k, v.clone())
            else:
                dict.__setitem__(node, k, copy.deepcopy(v))
        return node

    def merge_from_dict(self, other: Dict, path: str = "") -> None:
        if self.is_frozen():
            raise AttributeError("Cannot merge into a frozen CfgNode")
        for k, v in other.items():
            full = f"{path}.{k}" if path else k
            if k not in self:
                raise KeyError(f"Non-existent config key: {full}")
            cur = self[k]
            if isinstance(cur, CfgNode):
                if not isinstance(v, dict):
                    raise TypeError(f"Cannot merge non-dict into config group {full}")
                cur.merge_from_dict(v, full)
            else:
                dict.__setitem__(self, k, _coerce_value(cur, v, full))

    def to_dict(self) -> Dict:
        out: Dict = {}
        for k, v in self.items():
            out[k] = v.to_dict() if isinstance(v, CfgNode) else copy.deepcopy(v)
        return out

    def dump_yaml(self) -> str:
        import yaml

        return yaml.safe_dump(self.to_dict(), default_flow_style=None, sort_keys=False)

    def __deepcopy__(self, memo):
        return self.clone()

    def __str__(self) -> str:  # pragma: no cover - debugging aid
        return self.dump_yaml()


def _coerce_value(old: Any, new: Any, key: str) -> Any:
    """Coerce a replacement value to the type of the default (yacs-style)."""
    if old is None or new is None:
        return new
    if isinstance(old, bool) != isinstance(new, bool) and (
        isinstance(old, bool) or isinstance(new, bool)
    ):
        raise TypeError(f"Type mismatch for key {key}: {type(old)} vs {type(new)}")
    if isinstance(old, float) and isinstance(new, int):
        return float(new)
    if isinstance(old, (int, float)) and isinstance(new, str):
        # yacs literal_eval compatibility: YAML 1.1 parses dotless
        # scientific notation ("1e-8", the reference's OPTIMIZER.EPS)
        # as a STRING; coerce it back to the default's numeric type
        try:
            return type(old)(float(new))
        except ValueError:
            pass  # fall through to the type-mismatch error
    if isinstance(old, tuple) and isinstance(new, (list, tuple)):
        return tuple(new)
    if isinstance(old, list) and isinstance(new, (list, tuple)):
        return list(new)
    if type(old) is not type(new) and not (
        isinstance(old, (int, float)) and isinstance(new, (int, float))
    ):
        raise TypeError(
            f"Type mismatch for key {key}: default {type(old).__name__}, "
            f"got {type(new).__name__}"
        )
    return new


def default_config() -> CfgNode:
    """The default config tree (mirrors reference ``config.py:13-138``)."""
    c = CfgNode()
    c.BASE = [""]

    c.DATA = CfgNode()
    c.DATA.BATCH_SIZE = 2
    c.DATA.DATA_PATH = "./dataset"
    c.DATA.IMG_SIZE = 1024
    c.DATA.PIN_MEMORY = True
    c.DATA.NUM_WORKERS = 8

    c.HARDWARE = CfgNode()
    c.HARDWARE.N_GPU = 1  # reference knob name: data-parallel ranks (parallel/mesh.py)

    c.MODEL = CfgNode()
    c.MODEL.TYPE = "swin"
    c.MODEL.NAME = "swin_b"
    c.MODEL.PRETRAIN_WEIGHTS = "segface"  # segface | imagenet1k | none
    c.MODEL.PRETRAIN_CKPT = "./pretrained_ckpt/swin_b.pth"
    c.MODEL.PRETRAIN_SEGFACE = "./network/pretrained_weights/SegFace_swin_celaba_512.pt"
    c.MODEL.PRETRAIN_IMAGENET1K = "./network/pretrained_weights/swin_b-68c6b09e.pth"
    c.MODEL.NUM_CLASSES = 1
    c.MODEL.DROP_RATE = 0.0
    c.MODEL.DROP_PATH_RATE = 0.1
    c.MODEL.ATTN_DROP_RATE = 0.0
    c.MODEL.LABEL_SMOOTHING = 0.1  # kept for parity; unused by reference trainer too
    c.MODEL.FREEZE_ENCODER = True
    c.MODEL.STAGE3_UNFREEZE_PERIODE = 0.4
    c.MODEL.STAGE2_UNFREEZE_PERIODE = 0.7
    c.MODEL.STAGE1_UNFREEZE_PERIODE = 0.9
    c.MODEL.STAGE0_UNFREEZE_PERIODE = 0.98

    c.MODEL.SWIN = CfgNode()
    c.MODEL.SWIN.PATCH_SIZE = 4
    c.MODEL.SWIN.IN_CHANS = 3
    c.MODEL.SWIN.EMBED_DIM = 128
    c.MODEL.SWIN.DEPTHS = [2, 2, 18, 2]
    c.MODEL.SWIN.DECODER_DEPTHS = [2, 2, 6, 2]  # printed-only in reference; kept
    c.MODEL.SWIN.NUM_HEADS = [4, 8, 16, 32]
    c.MODEL.SWIN.WINDOW_SIZE = 7
    c.MODEL.SWIN.MLP_RATIO = 4.0
    c.MODEL.SWIN.QKV_BIAS = True
    c.MODEL.SWIN.QK_SCALE = None
    c.MODEL.SWIN.APE = False
    c.MODEL.SWIN.PATCH_NORM = True
    c.MODEL.SWIN.FINAL_UPSAMPLE = "expand_first"

    c.TRAIN = CfgNode()
    c.TRAIN.MAX_EPOCHS = 300
    c.TRAIN.START_EPOCH = 0
    c.TRAIN.WARMUP_EPOCHS = 20
    c.TRAIN.WEIGHT_DECAY = 0.1
    c.TRAIN.BASE_LR = 5e-4
    c.TRAIN.WARMUP_LR = 5e-7
    c.TRAIN.MIN_LR = 5e-6
    c.TRAIN.ACCUMULATION_STEPS = 1
    c.TRAIN.USE_CHECKPOINT = False  # recompute every stage's Swin blocks (as TPU.REMAT full)
    c.TRAIN.TVERSKY_LOSS_ALPHA = 0.4
    c.TRAIN.TVERSKY_LOSS_BETA = 0.6
    c.TRAIN.LOSS_TVERSKY_BCE_MIX = 0.5
    c.TRAIN.UF_LOSS_DELTA = 0.6
    c.TRAIN.UF_LOSS_GAMMA = 0.5
    c.TRAIN.UF_LOSS_WEIGTH = 0.5  # (sic) reference spelling, kept for YAML parity
    c.TRAIN.EARLY_STOPPING_PATIENCE = 15
    c.TRAIN.EARLY_STOPPING_FLAG = False
    c.TRAIN.SIG_THRESHOLD = 0.5

    c.TRAIN.LR_SCHEDULER = CfgNode()
    c.TRAIN.LR_SCHEDULER.NAME = "cosine"
    c.TRAIN.LR_SCHEDULER.WARMUP_PREFIX = True

    c.TRAIN.OPTIMIZER = CfgNode()
    c.TRAIN.OPTIMIZER.NAME = "adamw"
    c.TRAIN.OPTIMIZER.EPS = 1e-8
    c.TRAIN.OPTIMIZER.BETAS = (0.9, 0.999)

    c.TEST = CfgNode()
    c.TEST.SIG_THRESHOLD = 0.5

    c.OUTPUT_DIR = "./model_out"
    c.LIST_DIR = "./lists"
    c.SEED = 1234
    c.DETERMINISTIC = True
    c.SHOW_PREDICTIONS = 10
    c.SAVE_BEST_RUN = False
    c.SAVE_LAST_RUN = False
    c.DYNAMIC_LOADER = False

    # ---- the JAX package's extensions (absent in the reference) ----
    # Same keys and defaults, so one YAML drives both packages.  In the port:
    # COMPUTE_DTYPE / SOFTMAX_DTYPE set the compute types; the three kernel
    # knobs (USE_PALLAS_ATTENTION, FUSED_HEAD, FUSED_PATCH) select the CUDA
    # kernels, off meaning the composed PyTorch path; GELU_TANH picks the
    # GELU form; ATTN_WINDOW_GROUP and HOLD_WINDOW_LAYOUT are XLA layout
    # choices, read and ignored; MESH_SHAPE's first (data) axis is read and
    # ignored (HARDWARE.N_GPU sizes it, as in JAX), a model or space axis
    # above 1 raises (the trainer builds a data mesh only, as JAX's does);
    # SPATIAL_AXIS and MODEL_AXIS route every kernel off, as in JAX (the
    # groups come from parallel/mesh.py::make_mesh); REMAT recomputes Swin blocks in training
    # (models/msunet.py::resolve_remat); the trainer reads
    # PREFETCH_DEPTH (batches decoded ahead), DEVICE_PREFETCH (batches copied
    # to the card ahead), EVAL_BATCH, and CKPT_BACKEND / CKPT_ASYNC
    # ("orbax" raises: no PyTorch counterpart).
    c.TPU = CfgNode()
    c.TPU.COMPUTE_DTYPE = "bfloat16"  # bfloat16 | float32
    c.TPU.SOFTMAX_DTYPE = "float32"  # float32 | bfloat16
    c.TPU.USE_PALLAS_ATTENTION = True
    c.TPU.ATTN_WINDOW_GROUP = 0
    c.TPU.HOLD_WINDOW_LAYOUT = False
    c.TPU.GELU_TANH = True  # tanh GELU; False = exact erf
    c.TPU.FUSED_HEAD = True
    c.TPU.FUSED_PATCH = True
    c.TPU.MESH_SHAPE = [0]
    c.TPU.SPATIAL_AXIS = ""
    c.TPU.MODEL_AXIS = ""
    c.TPU.REMAT = "auto"  # auto | none | full | high_res | dots
    c.TPU.PREFETCH_DEPTH = 2
    c.TPU.DEVICE_PREFETCH = 2
    c.TPU.EVAL_BATCH = 1
    c.TPU.CKPT_BACKEND = "msgpack"  # msgpack (the single-file .pth writer) | orbax
    c.TPU.CKPT_ASYNC = False
    return c


def _merge_file_recursive(config: CfgNode, cfg_file: str) -> None:
    if cfg_file == "None" or cfg_file is None:
        raise ValueError("config file not found")
    import yaml

    with open(cfg_file, "r") as f:
        yaml_cfg = yaml.safe_load(f) or {}
    for base in yaml_cfg.get("BASE", [""]) or [""]:
        if base:
            _merge_file_recursive(
                config, os.path.join(os.path.dirname(cfg_file), base)
            )
    print(f"=> merge config from {cfg_file}", file=sys.stderr)
    yaml_cfg.pop("BASE", None)
    config.merge_from_dict(yaml_cfg)


def _update_config_from_file(config: CfgNode, cfg_file: str) -> None:
    """Recursive BASE-include merge then freeze (reference ``config.py:142-157``)."""
    config.defrost()
    _merge_file_recursive(config, cfg_file)
    config.freeze()


def update_config(config: CfgNode, bool_test: bool, bool_train: bool, args) -> None:
    """Merge a YAML file and validate flags (reference ``config.py:160-168``)."""
    _update_config_from_file(config, args.cfg)
    if bool_test and bool_train:
        raise ValueError("test and train flags are raised incorrectly (both true)!")
    if not bool_test and not bool_train:
        raise ValueError("test and train flags are raised incorrectly (both false)!")


def get_config(args, bool_train: bool, bool_test: bool) -> CfgNode:
    """Build a frozen config from defaults + an args.cfg YAML.

    Mirrors reference ``config.py:171-180``.
    """
    config = default_config()
    if args is None:
        raise ValueError("no arguments given")
    update_config(config, bool_test, bool_train, args)
    return config


def load_config(cfg_file: str) -> CfgNode:
    """Convenience loader: defaults merged with one YAML file, frozen."""
    config = default_config()
    _update_config_from_file(config, cfg_file)
    return config


def save_config(config: CfgNode, path: str) -> None:
    """Write the resolved config as YAML (the ``config_used.yaml`` copy)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(config.dump_yaml())
