"""Split-list generation and list utilities, offline dataset preparation
(a copy of the JAX package's ``data/splits.py``, which imports no JAX; the
lists it writes are byte-equal to JAX's).

Covers the reference's list tooling:

* :func:`create_splits` — integer-exact split search over (train,val,test)
  ratios with per-split fake ratios (reference ``lists/split_dataset.py``),
* :func:`create_splits_random` — simpler random sampling with real-count
  clamping (reference ``lists/split_dataset_v2.py``),
* :func:`filter_real_for_train` — all real ids not in val/test
  (``lists/filter_real_for_train.py``),
* :func:`split_train_in_real_and_fake` — partition train.txt by the "09"
  fake-id prefix (``lists/split_train_in_real_and_fake.py``),
* :func:`split_composition` — per-split real/fake counters
  (``lists/read_val.py``).
"""

from __future__ import annotations

import os
import random
from fractions import Fraction
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from .dataset import is_fake_id


def list_basenames(p: str) -> List[str]:
    return [f.stem for f in sorted(Path(p).glob("*")) if f.is_file()]


def write_list(path: str, names: List[str]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for n in names:
            f.write(n + "\n")


def read_list(path: str) -> List[str]:
    with open(path, "r", encoding="utf-8") as f:
        return [ln.strip() for ln in f if ln.strip()]


def _ratio_to_units(p_fake: float, max_den: int = 100) -> Tuple[int, int]:
    frac = Fraction(p_fake).limit_denominator(max_den)
    return frac.numerator, frac.denominator


def create_splits(
    real_dir: str,
    fake_dir: str,
    output_dir: str,
    split_ratio: Tuple[float, float, float] = (0.8, 0.1, 0.1),
    fake_ratio_in_train: float = 1.0,
    fake_ratio_in_val: float = 1.0,
    fake_ratio_in_test: float = 0.5,
    val_test_only_fake: bool = True,
    use_all_leftovers_in_train: bool = True,
    seed: int = 42,
) -> Dict[str, List[str]]:
    """Integer-exact split search (v1 semantics).

    Brute-forces integer multipliers (a, b, c) for the three splits such
    that the per-split fake ratios hold exactly and the split-size ratios
    are as close as possible to ``split_ratio`` (squared error), subject
    to using all fake images and not exceeding the real pool.
    """
    rng = random.Random(seed)
    real_all = list_basenames(real_dir)
    fake_all = list_basenames(fake_dir)
    rng.shuffle(real_all)
    rng.shuffle(fake_all)

    f_total, r_total = len(fake_all), len(real_all)
    s_tr, s_va, s_te = split_ratio
    if abs(s_tr + s_va + s_te - 1.0) > 1e-6:
        raise ValueError("split_ratio must sum to 1.0")

    tr_num, tr_den = _ratio_to_units(fake_ratio_in_train)
    if val_test_only_fake:
        va_num = va_den = te_num = te_den = 1
    else:
        va_num, va_den = _ratio_to_units(fake_ratio_in_val)
        te_num, te_den = _ratio_to_units(fake_ratio_in_test)

    best = None
    a_hi = f_total // max(1, tr_num)
    for a in range(a_hi + 1):
        fake_left = f_total - tr_num * a
        if fake_left < 0:
            break
        b_hi = fake_left // max(1, va_num)
        for b in range(b_hi + 1):
            c = fake_left - va_num * b
            if c < 0 or c % max(1, te_num) != 0:
                continue
            c //= max(1, te_num)
            totals = (tr_den * a, va_den * b, te_den * c)
            fakes = (tr_num * a, va_num * b, te_num * c)
            reals = tuple(t - f for t, f in zip(totals, fakes))
            n = sum(totals)
            if n == 0 or sum(reals) > r_total:
                continue
            probs = tuple(t / n for t in totals)
            err = sum((p - s) ** 2 for p, s in zip(probs, (s_tr, s_va, s_te)))
            score = (err, abs(probs[0] - s_tr), n)
            if best is None or score < best[0]:
                best = (score, totals, fakes, reals)
    if best is None:
        raise RuntimeError(
            "No valid integer split found (too few real images?)"
        )
    _, totals, fakes, reals = best

    fi = ri = 0
    splits: Dict[str, List[str]] = {}
    for name, f_n, r_n in zip(("train", "val", "test"), fakes, reals):
        splits[name] = fake_all[fi : fi + f_n] + real_all[ri : ri + r_n]
        fi += f_n
        ri += r_n
    if use_all_leftovers_in_train:
        splits["train"] += fake_all[fi:] + real_all[ri:]
    for name in splits:
        rng.shuffle(splits[name])
        write_list(os.path.join(output_dir, f"{name}.txt"), splits[name])
    return splits


def create_splits_random(
    real_dir: str,
    fake_dir: str,
    output_dir: str,
    n_val_fake: int = 100,
    n_val_real: int = 67,
    n_test_fake: int = 100,
    n_test_real: int = 67,
    train_real_cap: Optional[int] = None,
    seed: int = 42,
) -> Dict[str, List[str]]:
    """Simpler random-sampling splitter (v2 semantics) with real clamping."""
    rng = random.Random(seed)
    real_all = list_basenames(real_dir)
    fake_all = list_basenames(fake_dir)
    rng.shuffle(real_all)
    rng.shuffle(fake_all)
    if n_val_fake + n_test_fake > len(fake_all):
        raise ValueError("not enough fake images for val+test")
    if n_val_real + n_test_real > len(real_all):
        raise ValueError("not enough real images for val+test")

    val = fake_all[:n_val_fake] + real_all[:n_val_real]
    test = (fake_all[n_val_fake : n_val_fake + n_test_fake]
            + real_all[n_val_real : n_val_real + n_test_real])
    train_fake = fake_all[n_val_fake + n_test_fake :]
    train_real = real_all[n_val_real + n_test_real :]
    if train_real_cap is not None:
        train_real = train_real[:train_real_cap]
    train = train_fake + train_real

    splits = {"train": train, "val": val, "test": test}
    for name in splits:
        rng.shuffle(splits[name])
        write_list(os.path.join(output_dir, f"{name}.txt"), splits[name])
    return splits


def filter_real_for_train(real_dir: str, list_dir: str,
                          out_name: str = "real_train_all") -> List[str]:
    """All real basenames not present in val.txt/test.txt."""
    held_out = set(read_list(os.path.join(list_dir, "val.txt")))
    held_out |= set(read_list(os.path.join(list_dir, "test.txt")))
    names = [n for n in list_basenames(real_dir) if n not in held_out]
    write_list(os.path.join(list_dir, out_name + ".txt"), names)
    return names


def split_train_in_real_and_fake(list_dir: str) -> Tuple[List[str], List[str]]:
    """train.txt -> fake_train.txt / real_train.txt by the '09' prefix."""
    train = read_list(os.path.join(list_dir, "train.txt"))
    fake = [n for n in train if is_fake_id(n)]
    real = [n for n in train if not is_fake_id(n)]
    write_list(os.path.join(list_dir, "fake_train.txt"), fake)
    write_list(os.path.join(list_dir, "real_train.txt"), real)
    return fake, real


def split_composition(list_dir: str, split: str) -> Dict[str, int]:
    """Real/fake counters for a split (reference ``lists/read_val.py``)."""
    names = read_list(os.path.join(list_dir, split + ".txt"))
    n_fake = sum(1 for n in names if is_fake_id(n))
    return {"total": len(names), "fake": n_fake, "real": len(names) - n_fake}
