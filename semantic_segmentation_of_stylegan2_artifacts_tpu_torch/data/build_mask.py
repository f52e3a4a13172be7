"""CVAT-for-images-1.1 XML -> binary mask PNGs, offline dataset
preparation (a copy of the JAX package's ``data/build_mask.py``, PIL
imported where a mask is drawn; the masks are bit-equal to JAX's).

Capability parity with reference ``dataset/build_mask.py:44-98``: collect
``<polygon label="Artefakt">`` point strings ``x1,y1;x2,y2;...`` per
``<image>``, rasterize polygons with >=3 points into a 0/255 ``L`` PNG
named ``<base>_mask.png``, and optionally copy the source image next to
it.  Paths are CLI arguments here instead of hard-coded constants.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import xml.etree.ElementTree as ET
from typing import List, Optional, Sequence, Tuple

Point = Tuple[float, float]


def _as_point(token: str) -> Optional[Point]:
    """One ``'x,y'`` token -> ``(x, y)`` floats, or None if malformed."""
    x_str, sep, y_str = token.partition(",")
    if not sep or "," in y_str:
        return None
    try:
        return float(x_str), float(y_str)
    except ValueError:
        return None


def parse_points(points_str: str) -> List[Point]:
    """CVAT polygon attribute ``'x1,y1;x2,y2;...'`` -> vertex list.

    Tokens that are not exactly two comma-separated floats are dropped
    (tolerant-parse contract of reference ``dataset/build_mask.py:20-33``).
    """
    tokens = (t for t in points_str.strip().split(";") if t)
    return [p for p in map(_as_point, tokens) if p is not None]


def make_mask_for_image(width: int, height: int, polygons: Sequence[Sequence[Point]]):
    """Union of filled polygons as a 0/255 single-channel image.

    Degenerate polygons (<3 vertices) contribute nothing; both fill and
    outline are painted so boundary pixels land inside the mask
    (behavior contract of reference ``dataset/build_mask.py:35-42``).
    """
    from PIL import Image, ImageDraw

    canvas = Image.new("L", (width, height))
    pen = ImageDraw.Draw(canvas)
    for verts in polygons:
        if len(verts) < 3:
            continue
        pen.polygon([(float(x), float(y)) for x, y in verts],
                    fill=255, outline=255)
    return canvas


def build_masks(
    xml_path: str,
    out_mask_dir: str,
    image_dir: Optional[str] = None,
    out_image_dir: Optional[str] = None,
    label: str = "Artefakt",
    limit: Optional[int] = None,
    verbose: bool = True,
) -> int:
    """Process the XML; returns the number of masks written."""
    if not os.path.isfile(xml_path):
        raise FileNotFoundError(f"XML not found: {xml_path}")
    os.makedirs(out_mask_dir, exist_ok=True)
    if out_image_dir:
        os.makedirs(out_image_dir, exist_ok=True)

    root = ET.parse(xml_path).getroot()
    images = root.findall(".//image")
    if not images:
        raise ValueError("No <image> entries found in XML")
    to_process = images if limit is None else images[:limit]

    count = 0
    for img in to_process:
        name = img.get("name")
        width = int(float(img.get("width")))
        height = int(float(img.get("height")))
        polys = []
        for poly in img.findall("./polygon"):
            if poly.get("label") == label:
                pts = parse_points(poly.get("points", ""))
                if pts:
                    polys.append(pts)
        mask = make_mask_for_image(width, height, polys)
        base = os.path.splitext(os.path.basename(name))[0]
        mask.save(os.path.join(out_mask_dir, f"{base}_mask.png"), "PNG")
        count += 1

        if image_dir and out_image_dir:
            src = os.path.join(image_dir, name)
            if os.path.isfile(src):
                shutil.copy2(src, os.path.join(out_image_dir, name))
            elif verbose:
                print(f"Warning: source image not found -> {src}",
                      file=sys.stderr)
    return count


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="CVAT XML -> artifact masks (+ optional image copy)"
    )
    ap.add_argument("--xml", required=True)
    ap.add_argument("--out_mask_dir", required=True)
    ap.add_argument("--image_dir", default=None)
    ap.add_argument("--out_image_dir", default=None)
    ap.add_argument("--label", default="Artefakt")
    ap.add_argument("--limit", type=int, default=None)
    args = ap.parse_args(argv)
    n = build_masks(args.xml, args.out_mask_dir, args.image_dir,
                    args.out_image_dir, args.label, args.limit)
    print(f"Done. {n} masks written.")


if __name__ == "__main__":
    main()
