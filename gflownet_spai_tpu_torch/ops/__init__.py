"""Tile layouts and the CUDA kernels of the sampling and training paths:
the fused GATv2 tile forward and backward (K1, K2, ``gat_fused``) and the
windowed row gather and scatter-add (K3, K4, ``segment``); plus the band
statistics and the scans with analytic adjoints."""

from .gat_fused import (gat_tile_fused, gat_tile_fused_bwd,
                        gat_tile_fused_bwd_ref, gat_tile_fused_ref)
from .rcm import bandwidth, n_diagonals
from .scan import linear_scan, suffix_logsumexp
from .segment import (SegBuckets, SegTiles, SrcWindows, build_seg_buckets,
                      build_seg_tiles, build_src_windows, gather_rows_windows,
                      gather_rows_windows_ref, scatter_rows_windows,
                      scatter_rows_windows_ref, to_tiles)

__all__ = [
    "gat_tile_fused", "gat_tile_fused_bwd", "gat_tile_fused_bwd_ref",
    "gat_tile_fused_ref", "bandwidth", "n_diagonals", "linear_scan",
    "suffix_logsumexp", "SegBuckets", "SegTiles", "SrcWindows",
    "build_seg_buckets", "build_seg_tiles", "build_src_windows",
    "gather_rows_windows", "gather_rows_windows_ref", "scatter_rows_windows",
    "scatter_rows_windows_ref", "to_tiles",
]
