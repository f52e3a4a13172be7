"""The four-card check (``tools/multichip.py``) and the NCCL branches of the
port's parallel code, on the CPU.

* The check's arms as pure functions: its six meshes (data 4x1x1, model
  2x2x1 and 1x4x1, space 2x1x2 and 1x1x4 at 512^2, 1x1x4 at 64^2), each
  rank's coordinates against the JAX package's ``make_mesh`` over four
  devices, and the H-slabs at 512^2 (stage 3's 16 rows in 3 windows: one
  of four slabs empty) and at 64^2 (space rank 3 empty at every stage);
  ``attach_space`` on meshes whose slabs are empty from stage 0 on; the
  interconnect read from ``nvidia-smi topo -m``'s matrix.
* No fallback: with fewer than four cards (here none) or without NCCL the
  check raises before any process group, and its ranks ask for NCCL on the
  cards (``cuda``, rank ``r`` on ``cuda:r``), never gloo.
* ``parallel/mesh.py::rank_device`` / ``check_world`` for four cards, with
  ``torch.cuda.device_count`` patched.
* The agreement check both the four-card tool and the one-card smoke run
  (``tools/dp_check.py::hold_against_one``): two gloo ranks on the CPU
  against one process pass it, and other losses, launches or
  coordinates fail it; ``rank_rows``' busy share leaves the NCCL kernels
  out; ``tools/dp_check.py::time_steps``' keys, with the card's events,
  memory reads and profile stubbed; ``utils/profiling.py``'s one rule for
  the card's events (annotated ranges left out).
* The NCCL branches' arithmetic: inside four ``gloo`` ranks with
  ``dist.get_backend`` patched to ``"nccl"``, ``spatial._all_to_all``
  (through ``fetch_rows`` forward and backward, an empty slab's zero-count
  splits included), ``mesh._reduce_grads`` (all-reduce and broadcast) and
  ``mesh._collective`` keep their tensors where they are (no host copy)
  and give the gloo branch's results in bits.
* The train CLI at ``HARDWARE.N_GPU: 2`` prints every rank's
  ``epoch_timing`` line (rank 0's in ``log.txt``, the others' on standard
  output), each counting its native decodes.
"""

import contextlib
import inspect
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import yaml

from semantic_segmentation_of_stylegan2_artifacts_tpu.parallel.mesh import (
    make_mesh as jax_make_mesh,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.cli import train_cli
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.data.synthetic import (
    generate_synthetic_dataset,
)
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.parallel import mesh, spatial
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.tools import dp_check, multichip
from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.utils import profiling

ALL_MESHES = [(arm, i) for arm in multichip.MESHES for i in range(len(multichip.MESHES[arm]))]


@pytest.mark.parametrize("arm,index", ALL_MESHES)
def test_meshes_take_jax_layout(arm, index):
    """Each mesh has four ranks, and rank ``r``'s ``(data, model, space)``
    is the place of device ``r`` in JAX's ``make_mesh`` over four devices."""
    import jax

    got = multichip.arm_meshes(arm)[index]
    n_data, n_model, n_space = got["n_data"], got["n_model"], got["n_space"]
    assert n_data * n_model * n_space == multichip.WORLD == 4
    jm = jax_make_mesh(n_data, n_model, devices=jax.devices()[:4], n_space=n_space)
    grid = np.vectorize(lambda d: d.id)(jm.devices).reshape(n_data, n_model, n_space)
    want = [tuple(int(i) for i in np.argwhere(grid == grid.flat[r])[0]) for r in range(4)]
    assert got["coords"] == want
    assert [(d * n_model + m) * n_space + s for d, m, s in got["coords"]] == [0, 1, 2, 3]


def test_the_meshes_cover_every_axis():
    assert {m[:3] for ms in multichip.MESHES.values() for m in ms} == {
        (4, 1, 1), (2, 2, 1), (1, 4, 1), (2, 1, 2), (1, 1, 4)}
    assert [m["img"] for m in multichip.arm_meshes("space")] == [512, 512, 64]
    assert {m[3] for arm in ("data", "model") for m in multichip.MESHES[arm]} == {512}


@pytest.mark.parametrize("n_space,want", [
    (2, [((0, 70), (70, 128)), ((0, 35), (35, 64)), ((0, 21), (21, 32)),
         ((0, 14), (14, 16))]),
    (4, [((0, 35), (35, 70), (70, 105), (105, 128)), ((0, 21), (21, 42), (42, 56), (56, 64)),
         ((0, 14), (14, 21), (21, 28), (28, 32)), ((0, 7), (7, 14), (14, 16), (16, 16))]),
])
def test_stage_slabs_at_512(n_space, want):
    """Window-aligned H-slabs of Swin-B's four stages at 512^2 (grids
    128/64/32/16, window 7): four space ranks leave stage 3's last slab
    empty, and a fetch of its shifted windows sends that rank zero rows."""
    slabs = multichip.stage_slabs(n_space)
    assert slabs == want
    if n_space == 4:
        bounds = slabs[3]
        wins = spatial.window_rows(16, 7, 4)
        requests = tuple((a * 7 + 3, b * 7 + 3) for a, b in wins)
        plan = spatial.exchange_plan(bounds, 16, 21, requests, 3)
        assert plan.size == 0 and sum(plan.send_counts) == 0 and plan.remote


@pytest.mark.parametrize("img,n_space,empty", [
    (32, 4, [[2, 3], [1, 2, 3], [1, 2, 3], [1, 2, 3]]),
    (32, 2, [[], [1], [1], [1]]),
    (128, 4, [[], [3], [2, 3], [1, 2, 3]]),
    (512, 4, [[], [], [], [3]]),
    (multichip.EMPTY_IMG, 4, [[3], [2, 3], [1, 2, 3], [1, 2, 3]]),
])
def test_attach_space_reports_the_empty_slabs(img, n_space, empty, monkeypatch):
    """``attach_space`` takes every mesh, also where a rank holds no pixel
    rows: four space ranks at 32^2 (JAX's data 2 x space 4 model; stage 0's
    8 rows make two windows of 4) leave ranks 2 and 3 empty from stage 0
    on, as 512^2 leaves rank 3 empty at stage 3 and the space arm's 64^2
    mesh (stage 0's 16 rows in 3 windows of 7) at every stage.  Every
    module of the model gets the group's shard, whose slabs say which ranks
    are empty, as the tool's ``stage_slabs`` prints them."""
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.models.msunet import MSUNet

    monkeypatch.setattr(spatial.dist, "get_world_size", lambda group=None: n_space)
    monkeypatch.setattr(spatial.dist, "get_rank", lambda group=None: n_space - 1)
    model = MSUNet(img_size=img, embed_dim=8, depths=(1, 1, 1, 1), num_heads=(2,) * 4,
                   window_size=4 if img == 32 else 7, spatial_axis="space")
    space = spatial.attach_space(model, None)
    assert (space.size, space.rank) == (n_space, n_space - 1)
    assert all(m.space is space for m in model.modules() if hasattr(m, "space"))
    grids = [img // 4 >> i for i in range(4)]
    assert [[s for s, (lo, hi) in enumerate(space.slabs(g).bounds) if lo == hi]
            for g in grids] == empty
    if img != 32:
        assert multichip.stage_slabs(n_space, img) == [space.slabs(g).bounds for g in grids]


def test_link_kinds_reads_the_topology_matrix():
    topo = ("\tGPU0\tGPU1\tGPU2\tGPU3\tCPU Affinity\n"
            "GPU0\t X \tNV18\tNV18\tNV18\t0-31\n"
            "GPU1\tNV18\t X \tNV18\tNV18\t0-31\n"
            "GPU2\tNV18\tNV18\t X \tNV18\t0-31\n"
            "GPU3\tNV18\tNV18\tNV18\t X \t0-31\n\nLegend:\n  X    = Self\n")
    assert multichip.link_kinds(topo) == ["NV18"]
    assert multichip.link_kinds(topo.replace("NV18", "SYS", 1)) == ["NV18", "SYS"]
    assert multichip.link_kinds("no matrix") == []


def test_multichip_refuses_fewer_than_four_cards(monkeypatch):
    """No fallback: here (no card) the check raises before it starts any
    process group; with three cards, or four without NCCL, too."""
    def no_group(*a, **k):
        raise AssertionError("a process group was started")

    monkeypatch.setattr(dist, "init_process_group", no_group)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="needs 4 CUDA cards, have 0"):
        multichip.main([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    with pytest.raises(RuntimeError, match="needs 4 CUDA cards, have 3"):
        multichip.main([])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs NCCL"):
        multichip.main([])


def test_multichip_asks_for_nccl_on_the_cards(monkeypatch):
    """Every arm's ranks run on the cards over NCCL: the spec names
    ``cuda`` and ``nccl``, and the module asks for gloo nowhere."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for arm in multichip.MESHES:
        for m in multichip.arm_meshes(arm):
            spec = multichip.arm_spec("c.yaml", [], m, None)
            assert (spec["device"], spec["backend"]) == ("cuda", "nccl")
            assert (spec["n_model"], spec["n_space"]) == (m["n_model"], m["n_space"])
    assert "\"gloo\"" not in inspect.getsource(multichip)


def test_rank_device_and_check_world_for_four_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh.check_world(4, "cuda")
    with pytest.raises(ValueError, match="mesh 5x1x1 needs 5 devices, have 4"):
        mesh.check_world(5, "cuda")
    assert [mesh.rank_device(r) for r in range(4)] == [torch.device("cuda", r)
                                                       for r in range(4)]
    assert mesh.rank_device(3, "cuda:0") == torch.device("cuda", 0)
    assert mesh.rank_device(3, "cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="need an explicit backend"):
        mesh.check_world(4, "cuda:0")
    mesh.check_world(4, "cuda:0", backend="gloo")
    mesh.check_world(4, "cpu")


# -- the agreement check and the timed rows ----------------------------------

TINY = """\
DATA:
  IMG_SIZE: 32
MODEL:
  DROP_RATE: 0.0
  ATTN_DROP_RATE: 0.0
  DROP_PATH_RATE: 0.0
  PRETRAIN_WEIGHTS: none
  SWIN:
    EMBED_DIM: 16
    DEPTHS: [1, 1, 1, 1]
    NUM_HEADS: [2, 2, 2, 2]
    WINDOW_SIZE: 4
TPU:
  COMPUTE_DTYPE: float32
  USE_PALLAS_ATTENTION: false
  FUSED_HEAD: false
  FUSED_PATCH: false
  REMAT: none
"""


def test_hold_against_one_on_two_gloo_ranks(tmp_path, monkeypatch, capsys):
    """Two gloo ranks on the CPU (data axis 2) against one process over the
    same global batches pass; the same ranks fail it against other losses,
    other launch counts or other coordinates, each naming the check."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the spawned ranks' threads
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        path = tmp_path / "tiny.yaml"
        path.write_text(TINY)
        rng = np.random.default_rng(3)
        batches = [dp_check.train_batch(rng, 4, img=32) for _ in range(2)]
        spec = dp_check.make_spec(str(path), batches, 1e-3, device="cpu")
        one = dp_check.run_steps(spec)
        ranks, agreement = dp_check.hold_against_one("tiny dp", spec, 2,
                                                     str(tmp_path / "ranks"), one, {})
    finally:
        torch.set_num_threads(n)
    assert [r["coords"] for r in ranks] == [(0, 0, 0), (1, 0, 0)]
    assert agreement["loss_diff"] <= dp_check.LOSS_TOL
    assert agreement["param_diff"] <= 2 * 1e-3 * 2
    assert agreement["elements"] == sum(v.numel() for v in one["state_dict"].values())
    assert "tiny dp: launches none a step on every rank" in capsys.readouterr().out
    monkeypatch.setattr(dp_check, "spawn_steps", lambda *a: ranks)  # the same ranks again
    far = dict(one, losses=[x + 1e-3 for x in one["losses"]])
    with pytest.raises(AssertionError, match="tiny dp: the ranks differ from one process"):
        dp_check.hold_against_one("tiny dp", spec, 2, str(tmp_path), far, {})
    with pytest.raises(AssertionError, match="tiny dp: one process launched"):
        dp_check.hold_against_one("tiny dp", spec, 2, str(tmp_path), one,
                                  {"window_attention": 1})
    with pytest.raises(AssertionError, match="tiny dp: coordinates"):
        dp_check.hold_against_one("tiny dp", dict(spec, n_model=2), 2, str(tmp_path), one, {})


def test_rank_rows_leave_the_nccl_kernels_out_of_busy(capsys):
    ranks = [{"coords": (r, 0, 0), "ms": 100.0, "host_ms": 110.0, "device_ms": 90.0,
              "peak_gib": 2.0, "nccl": {"ncclDevKernel_AllReduce": (10.0 + r, 4)}}
             for r in range(2)]
    rows = dp_check.rank_rows("dp", ranks, 8, "card")
    assert [(r["rank"], r["nccl_ms"], r["img_s"]) for r in rows] == [(0, 10.0, 80.0),
                                                                     (1, 11.0, 80.0)]
    assert rows[0]["busy"] == pytest.approx(0.8) and rows[1]["busy"] == pytest.approx(0.79)
    assert capsys.readouterr().out.count("of which NCCL kernels") == 2


def test_time_steps_keys_on_a_tiny_config(tmp_path, monkeypatch):
    """``time_steps`` on the CPU with the card's parts stubbed: CUDA events
    that read 12 ms a step, the memory reads, and a profile of one
    step that shows a GEMM and two NCCL kernels.  It warms up once, times
    ``steps`` steps, profiles one more, and splits the collectives out."""
    path = tmp_path / "tiny.yaml"
    path.write_text(TINY)

    class Event:
        def __init__(self, enable_timing=False):
            pass

        def record(self):
            pass

        def elapsed_time(self, end):
            return 12.0 * 3  # three steps

    profiled = []

    def kernel_times(fn, device=None):
        profiled.append((float(fn()), device))
        return [(4.0, 3, "gemm"), (1.5, 2, "ncclDevKernel_AllReduce_Sum_f32"),
                (0.5, 1, "ncclDevKernel_Broadcast")]

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 3 * 2**29)
    monkeypatch.setattr(profiling, "kernel_times", kernel_times)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = dp_check.time_steps(str(path), 2, 3, "cpu")
    finally:
        torch.set_num_threads(n)
    assert set(out) == {"ms", "host_ms", "peak_gib", "timed_launches", "timed_losses",
                        "device_ms", "nccl"}
    assert out["ms"] == 12.0 and out["host_ms"] > 0 and out["peak_gib"] == 1.5
    assert out["timed_launches"] == {k: 0 for k in out["timed_launches"]}
    assert len(out["timed_losses"]) == 3 and all(np.isfinite(out["timed_losses"]))
    assert out["device_ms"] == 6.0
    assert out["nccl"] == {"ncclDevKernel_AllReduce_Sum_f32": (1.5, 2),
                           "ncclDevKernel_Broadcast": (0.5, 1)}
    assert len(profiled) == 1 and np.isfinite(profiled[0][0])
    assert profiled[0][1] == torch.device("cpu")
    row, = dp_check.rank_rows("tiny", [dict(out, coords=(0, 0, 0))], 2, "card")
    assert row["nccl_ms"] == 2.0 and row["busy"] == pytest.approx(4.0 / 12.0)


def test_card_events_leave_annotations_out():
    """One rule for ``kernel_times`` and ``section_times``: the card's
    kernels and copies, not the card's copies of annotated ranges."""
    from torch.autograd import DeviceType

    class Ev:
        def __init__(self, name, device_type, annotation=False):
            self.name, self.device_type, self.is_user_annotation = name, device_type, annotation

    class Prof:
        def events(self):
            return [Ev("aten::mm", DeviceType.CPU), Ev("gemm", DeviceType.CUDA),
                    Ev("Optimizer.step#AdamW.step", DeviceType.CUDA, True),
                    Ev("ncclDevKernel_AllReduce", DeviceType.CUDA)]

    assert [e.name for e in profiling._card_events(Prof())] == ["gemm",
                                                                 "ncclDevKernel_AllReduce"]


# -- the NCCL branches inside four gloo ranks --------------------------------

H, W, C, WIN, SHIFT = 16, 16, 5, 7, 3


def _global_map(seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (2, H, W, C)).astype(np.float32))


def _branch(nccl: bool):
    """The exchanges and reductions of this rank on one backend branch;
    each result with the host copies (``Tensor.cpu``) it made."""
    real = dist.get_backend
    copies = []
    orig_cpu = torch.Tensor.cpu

    def counting_cpu(self, *a, **k):
        copies.append(tuple(self.shape))
        return orig_cpu(self, *a, **k)

    torch.Tensor.cpu = counting_cpu
    if nccl:
        dist.get_backend = lambda group=None: "nccl"
    try:
        rank = dist.get_rank()
        space = spatial.SpaceShard(dist.group.WORLD, WIN)
        slabs = space.slabs(H)
        lo, hi = slabs.bounds[rank]
        x = _global_map(0)[:, lo:hi].clone().requires_grad_(True)
        wins = spatial.window_rows(H, WIN, 4)
        requests = tuple((a * WIN + SHIFT, b * WIN + SHIFT) for a, b in wins)
        y = spatial.fetch_rows(x, space, slabs, 21, requests)
        g = torch.from_numpy(np.random.default_rng(10 + rank).standard_normal(
            tuple(y.shape)).astype(np.float32))
        y.backward(g)
        out = {"rows": y.detach(), "grad": x.grad}
        params = [torch.nn.Parameter(torch.zeros(n)) for n in (7, 1, 12)]
        for i, p in enumerate(params):
            p.grad = torch.from_numpy(np.random.default_rng(100 * rank + i).standard_normal(
                p.shape).astype(np.float32))
        mesh._reduce_grads(params[:2], None)
        mesh._reduce_grads(params[2:], None, src=2)
        out["grads"] = [p.grad.clone() for p in params]
        t = torch.arange(6.0)
        out["collective_is_self"] = mesh._collective(t) is t
        return out, copies
    finally:
        torch.Tensor.cpu = orig_cpu
        dist.get_backend = real


def _nccl_branch_rank(rank: int, world: int, init: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        gloo, gloo_copies = _branch(nccl=False)
        nccl, nccl_copies = _branch(nccl=True)
        assert nccl_copies == [], nccl_copies  # nothing through host memory
        assert gloo_copies  # the gloo branch copies to the host (here: itself)
        assert nccl["collective_is_self"]
        for key in ("rows", "grad"):
            assert torch.equal(nccl[key], gloo[key]), key
        for a, b in zip(nccl["grads"], gloo["grads"]):
            assert torch.equal(a, b)
        # the fetched rows are the global map's: rows wrap at 21, zeros at 16..20
        full = _global_map(0)
        lo, hi = spatial.window_rows(H, WIN, 4)[rank]
        want = torch.zeros(2, (hi - lo) * WIN, W, C)
        for i, g in enumerate(range(lo * WIN + SHIFT, hi * WIN + SHIFT)):
            if g % 21 < H:
                want[:, i] = full[:, g % 21]
        assert torch.equal(nccl["rows"], want)
        if rank == 3:  # stage 3's empty slab at 512^2, four space ranks
            assert nccl["rows"].shape[1] == 0 and nccl["grad"].shape[1] == 0
        # all-reduce: the sum of the ranks' gradients; broadcast: rank 2's
        total = [sum(torch.from_numpy(np.random.default_rng(100 * r + i).standard_normal(
            n).astype(np.float32)) for r in range(world)) for i, n in enumerate((7, 1))]
        for got, want_g in zip(nccl["grads"][:2], total):
            torch.testing.assert_close(got, want_g, rtol=1e-6, atol=1e-6)
        rank2 = torch.from_numpy(np.random.default_rng(200 + 2).standard_normal(12).astype(
            np.float32))
        assert torch.equal(nccl["grads"][2], rank2)
    finally:
        dist.destroy_process_group()


def test_nccl_branches_keep_tensors_in_place(tmp_path):
    """Four gloo ranks hold the NCCL branch of ``_all_to_all`` (an empty
    slab's zero-count splits included), ``_reduce_grads`` and
    ``_collective`` to the gloo branch in bits, with no host copy."""
    torch.multiprocessing.spawn(_nccl_branch_rank,
                                args=(4, "file://" + str(tmp_path / "rdv")), nprocs=4)


# -- every rank's epoch_timing through the train CLI ---------------------------


def test_train_cli_prints_every_ranks_epoch_timing(tmp_path, capfd, monkeypatch):
    """``HARDWARE.N_GPU: 2`` on two gloo ranks: rank 0's ``epoch_timing``
    in ``log.txt``, rank 1's on standard output behind ``rank 1:``, each
    with its steps and native decodes; rank 0 alone validates."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the spawned ranks' threads
    data = str(tmp_path / "data")
    generate_synthetic_dataset(data, img_size=32, seed=6, n_fake_train=6, n_real_train=4,
                               n_val_fake=1, n_val_real=1)
    cfg = {"DATA": {"IMG_SIZE": 32, "DATA_PATH": data, "NUM_WORKERS": 1},
           "HARDWARE": {"N_GPU": 2},
           "MODEL": {"PRETRAIN_WEIGHTS": "none", "DROP_PATH_RATE": 0.0,
                     "SWIN": {"EMBED_DIM": 16, "DEPTHS": [1, 1, 1, 1],
                              "NUM_HEADS": [2, 2, 2, 2], "WINDOW_SIZE": 4}},
           "TRAIN": {"MAX_EPOCHS": 1, "WARMUP_EPOCHS": 0},
           "TPU": {"COMPUTE_DTYPE": "float32"},
           "LIST_DIR": os.path.join(data, "lists"), "OUTPUT_DIR": str(tmp_path / "run")}
    path = str(tmp_path / "c.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    train_cli.main(["--cfg", path, "--device", "cpu"])
    out = capfd.readouterr().out
    with open(tmp_path / "run" / "log.txt") as f:
        log = f.read()
    timings = multichip.rank_timings(log, out)
    assert sorted(timings) == [0, 1]
    assert [line.split("epoch_timing")[0] for line in out.splitlines()
            if "epoch_timing " in line] == ["rank 1: "]
    for rank, (t,) in timings.items():
        assert t["epoch"] == 1 and t["steps"] == timings[0][0]["steps"] > 0
        assert t["decodes"]["pil"] == 0 and t["decodes"]["native"] > 0
        assert t["val_cases"] == (2 if rank == 0 else 0)
    assert "rank 1: rank_sync " in out
    assert json.loads(out.split("rank 1: rank_sync ", 1)[1].splitlines()[0])["world"] == 2
