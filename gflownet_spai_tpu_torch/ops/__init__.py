"""Tile layouts and the CUDA kernels of the sampling, training and
validation paths: the fused GATv2 tile forward and backward (K1, K2,
``gat_fused``), the windowed row gather and scatter-add (K3, K4,
``segment``) and the DIA SpMV, fused k-step SpMV and fused Chebyshev
steps (K8, K12, K13, ``dia``); plus the band statistics and the scans
with analytic adjoints."""

from .dia import (DIA, coo_to_dia, dia_to_coo, dia_transpose, spmv_dia,
                  spmv_dia_cheby, spmv_dia_padded, spmv_dia_power)
from .gat_fused import (gat_tile_fused, gat_tile_fused_bwd,
                        gat_tile_fused_bwd_ref, gat_tile_fused_ref)
from .rcm import bandwidth, n_diagonals
from .scan import linear_scan, suffix_logsumexp
from .segment import (SegBuckets, SegTiles, SrcWindows, build_seg_buckets,
                      build_seg_tiles, build_src_windows, gather_rows_windows,
                      gather_rows_windows_ref, scatter_rows_windows,
                      scatter_rows_windows_ref, to_tiles)

__all__ = [
    "DIA", "coo_to_dia", "dia_to_coo", "dia_transpose", "spmv_dia",
    "spmv_dia_cheby", "spmv_dia_padded", "spmv_dia_power",
    "gat_tile_fused", "gat_tile_fused_bwd", "gat_tile_fused_bwd_ref",
    "gat_tile_fused_ref", "bandwidth", "n_diagonals", "linear_scan",
    "suffix_logsumexp", "SegBuckets", "SegTiles", "SrcWindows",
    "build_seg_buckets", "build_seg_tiles", "build_src_windows",
    "gather_rows_windows", "gather_rows_windows_ref", "scatter_rows_windows",
    "scatter_rows_windows_ref", "to_tiles",
]
