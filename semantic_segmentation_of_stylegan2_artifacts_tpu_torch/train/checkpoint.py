"""Checkpoints: atomic best and last saves, a background writer, and
readers for the JAX package's ``.msgpack`` files and orbax directories
(counterpart of the JAX package's ``train/checkpoint.py``; reference
``trainer.py:361-409``).

* ``best_model.pth``: ``{'model': state_dict, 'epoch', 'best_score'}``, the
  reference's payload; the keys carry the ``ms_unet.`` prefix of the
  reference trainer's wrapper, so ``models/weights.py::load_reference_checkpoint``
  and the JAX package's test CLI read it.
* ``epoch_N.pth``: model, optimizer ``state_dict``, epoch, ``iter_num`` and
  dice, for ``--resume``.
* Every write goes to a tmp file first and is moved over the target with
  ``os.replace``.
* ``backend="orbax"`` (``TPU.CKPT_BACKEND: orbax``) writes
  ``best_model.orbax`` and ``epoch_N.orbax`` directories instead
  (``train/orbax.py``) holding the JAX package's trees: ``model`` in the
  flax layout (``models/weights.py``), the optimizer as optax's state
  (``train/optim.py::to_optax``), so either package reads either's.
* :func:`load_best_state_dict` reads a best checkpoint of either package.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..models.weights import flax_to_state_dict, load_reference_checkpoint, state_dict_to_flax
from . import orbax
from .optim import to_optax


def snapshot(tree: Any) -> Any:
    """A copy of ``tree`` whose tensors live in host memory, taken now:
    parameters and optimizer moments change in place at the next step."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(snapshot(v) for v in tree)
    return tree


def save_checkpoint(path: str, payload: Dict) -> None:
    """``torch.save`` to ``path + '.tmp'``, then ``os.replace`` onto ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict:
    """A payload this module wrote (tensors on the CPU)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def _msgpack_ext(code: int, data: bytes):
    """flax's msgpack ext types: 1 ndarray, 3 numpy scalar (both packed as
    ``(shape, dtype name, C-order bytes)``), 2 complex."""
    import msgpack

    if code in (1, 3):
        shape, dtype, buf = msgpack.unpackb(data, raw=True)
        arr = np.frombuffer(buf, dtype=np.dtype(dtype.decode())).reshape(shape)
        return arr if code == 1 else arr[()]
    if code == 2:
        re, im = msgpack.unpackb(data)
        return complex(re, im)
    return msgpack.ExtType(code, data)


def read_msgpack(path: str) -> Dict:
    """The raw tree of a JAX package checkpoint (``flax.serialization``'s
    msgpack), numpy leaves."""
    import msgpack

    with open(path, "rb") as f:
        return msgpack.unpackb(f.read(), ext_hook=_msgpack_ext, raw=False)


def load_jax_best(path: str) -> Dict:
    """A JAX ``best_model.msgpack`` as ``{'model': MSUNetSys state dict,
    'epoch', 'best_score'}``."""
    raw = read_msgpack(path)
    return {**raw, "model": flax_to_state_dict(raw["model"])}


def load_orbax(path: str) -> Dict:
    """An orbax checkpoint directory of either package, its ``model`` as an
    ``MSUNetSys`` state dict; the rest (``optimizer``: optax's state) raw."""
    raw = orbax.restore(path)
    return {**raw, "model": flax_to_state_dict(raw["model"])}


def _flax_params(model: torch.nn.Module) -> Dict:
    """The parameters of ``model``'s network in the flax layout, copied."""
    return state_dict_to_flax(getattr(model, "ms_unet", model).state_dict())


class CheckpointWriter:
    """Best and last checkpoints, written in the caller's thread or, with
    ``async_``, by one background thread in submission order.

    Either way the payload is copied to host memory before ``save_*``
    returns, so the next optimizer step cannot change what is written.
    :meth:`wait` blocks until every save is on disk and re-raises a failed
    background save; :meth:`close` waits and stops the thread.

    ``backend``: ``msgpack`` is the JAX package's name for its single-file
    writer, here ``torch.save`` to ``.pth``; ``orbax`` writes the JAX
    package's orbax directories (``train/orbax.py``)."""

    def __init__(self, backend: str = "msgpack", async_: bool = False):
        if backend not in ("msgpack", "orbax"):
            raise ValueError(f"unknown checkpoint backend: {backend!r}")
        self.backend = backend
        self._error: Optional[BaseException] = None
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        if async_:
            self._queue = queue.Queue()
            self._thread = threading.Thread(target=self._drain, name="ckpt-writer",
                                            daemon=True)
            self._thread.start()

    def save_best(self, log_dir: str, model: torch.nn.Module, epoch: int,
                  best_score: float) -> str:
        if self.backend == "orbax":
            path = os.path.join(log_dir, "best_model.orbax")
            self._submit(path, {"model": _flax_params(model), "epoch": int(epoch),
                                "best_score": float(best_score)})
            return path
        path = os.path.join(log_dir, "best_model.pth")
        self._submit(path, snapshot({"model": model.state_dict(), "epoch": int(epoch),
                                     "best_score": float(best_score)}))
        return path

    def save_last(self, log_dir: str, epoch: int, model: torch.nn.Module,
                  optimizer: torch.optim.Optimizer, iter_num: int, dice: float) -> str:
        if self.backend == "orbax":
            path = os.path.join(log_dir, f"epoch_{epoch}.orbax")
            self._submit(path, {"epoch": int(epoch), "model": _flax_params(model),
                                "optimizer": to_optax(optimizer, model),
                                "iter_num": int(iter_num), "dice": float(dice)})
            return path
        path = os.path.join(log_dir, f"epoch_{epoch}.pth")
        self._submit(path, snapshot({"epoch": int(epoch), "model": model.state_dict(),
                                     "optimizer": optimizer.state_dict(),
                                     "iter_num": int(iter_num), "dice": float(dice)}))
        return path

    def wait(self) -> None:
        """Block until every submitted save is on disk; re-raise a failure."""
        if self._queue is not None:
            self._queue.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()
        if self._thread is not None:
            self._queue.put(None)
            self._thread.join(timeout=60)
            self._thread = None

    def _write(self, path: str, payload: Dict) -> None:
        if self.backend == "orbax":
            orbax.save(path, payload)
        else:
            save_checkpoint(path, payload)

    def _submit(self, path: str, payload: Dict) -> None:
        """``payload`` is a copy already: nothing the next step changes."""
        if self._queue is None:
            self._write(path, payload)
            return
        if self._error is not None:
            self.wait()  # surface an earlier failure now
        self._queue.put((path, payload))

    def _drain(self) -> None:
        while True:
            job = self._queue.get()
            try:
                if job is None:
                    return
                self._write(*job)
            except Exception as e:  # noqa: BLE001 - re-raised by wait()
                self._error = e
            finally:
                self._queue.task_done()


# the order in which each CLI looks for a best checkpoint in a directory,
# as the JAX package's CLIs do: the predict CLI the port's ``.pth`` first
# (JAX ``cli/predict_cli.py``), the test CLI the JAX ``.msgpack`` first (JAX
# ``cli/test_cli.py::_resolve_checkpoint``)
PREDICT_ORDER = ("best_model.pth", "best_model.msgpack", "best_model.orbax")
TEST_ORDER = ("best_model.msgpack", "best_model.pth", "best_model.orbax")


def resolve_checkpoint(path: str, order=PREDICT_ORDER) -> str:
    """A best checkpoint: ``path`` itself when it is a file, or an orbax
    checkpoint directory (a name ending in ``.orbax``, JAX ``cli/test_cli.py``,
    or holding ``_CHECKPOINT_METADATA``, JAX ``load_best``) with no name of
    ``order`` in it; else the first name of ``order`` in the directory."""
    if not os.path.isdir(path):
        return path
    for name in order:
        cand = os.path.join(path, name)
        if os.path.exists(cand):
            return cand
    if path.rstrip("/").endswith(".orbax") or orbax.is_checkpoint(path):
        return path
    raise FileNotFoundError(f"No best_model checkpoint in {path}")


def load_best_state_dict(path: str, order=PREDICT_ORDER) -> Dict[str, torch.Tensor]:
    """The ``MSUNetSys`` state dict of a best checkpoint (file or directory,
    see :func:`resolve_checkpoint`): a reference-layout ``.pth``/``.pt``, a
    JAX ``.msgpack`` or an orbax directory of either package."""
    path = resolve_checkpoint(path, order)
    if os.path.isdir(path):
        return load_orbax(path)["model"]
    if path.endswith(".msgpack"):
        return load_jax_best(path)["model"]
    if path.endswith((".pth", ".pt")):
        return load_reference_checkpoint(path)
    raise ValueError(f"{path}: not a .pth, .pt, .msgpack or orbax checkpoint")
