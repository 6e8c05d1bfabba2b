"""Analytical à-trous footprint model.

Code-ified version of the reference's design notebook (``notebooks/tile.ipynb``
cells 197-205, SURVEY.md §2 C13): dilation spacing, halo radius and tile
extent per level, plus the halo bytes a device exchanges per level on the
sharded path (parallel/halo.py).
"""

from __future__ import annotations

from typing import List


def spacing(level: int) -> int:
    """À-trous hole size at ``level`` (SVGF convention: 2^level).

    The notebook uses ``space(n) = 2^(n-1)`` with n starting at 1; levels here
    are 0-based so ``spacing(l) == notebook.space(l+1)``.
    """
    return 1 << level


def halo_radius(radius: int, level: int) -> int:
    """Pixels of halo a level-``level`` pass needs beyond a tile edge."""
    return radius * spacing(level)


def tile_extent(radius: int, level: int, block: int) -> int:
    """Full extent of a block's input window (notebook ``tileRad``)."""
    return 2 * halo_radius(radius, level) + block


def halo_bytes(tile_h: int, tile_w: int, radius: int, levels: int,
               n_planes: int = 9, dtype_bytes: int = 4) -> List[int]:
    """Per-level halo bytes one device receives for a (tile_h, tile_w) tile:
    rows on both sides plus columns on both sides including the corners."""
    out = []
    for lvl in range(levels):
        h = halo_radius(radius, lvl)
        cells = 2 * h * tile_w + 2 * h * (tile_h + 2 * h)
        out.append(n_planes * cells * dtype_bytes)
    return out


def print_model(tile_h: int = 540, tile_w: int = 960, radius: int = 2,
                levels: int = 5) -> None:
    """Human-readable dump (the notebook's printed tables)."""
    print(f"à-trous model: tile {tile_h}x{tile_w}, r={radius}")
    for lvl, b in enumerate(halo_bytes(tile_h, tile_w, radius, levels)):
        print(f"  level {lvl}: spacing {spacing(lvl):2d}, "
              f"halo {halo_radius(radius, lvl):2d}, "
              f"tile extent {tile_extent(radius, lvl, tile_h):4d} rows, "
              f"halo {b / 2**20:.2f} MiB")
