"""Tile layouts and the CUDA kernels of the port: the fused GATv2 tile
forward and backward (K1, K2, ``gat_fused``), the tile segment softmax,
sum and broadcast of the generic GAT layer (K5, K6, K7) and the windowed
row gather and scatter-add (K3, K4, ``segment``), the DIA family
(``dia``): SpMV (K8), padded-IO and ping-pong SpMV (K10, K11), fused
k-step SpMV on one or K right-hand sides (K12, K14), fused Chebyshev
steps (K13) and the SpMMs (K15, K16), on float32 or bf16 diagonals
(``dia_astype``), and the block-ELL SpMM (K17,
``bsr``) on float32 or bf16 blocks; plus the banded product ``spgemm_dia`` (plain PyTorch), the
RCM reordering, the band statistics and the scans with analytic
adjoints."""

from .bsr import BELL, csr_to_bell, spmm_bell, spmm_bell_ref, spmv_bell
from .dia import (DIA, coo_to_dia, dia_astype, dia_pad_io, dia_pad_pp, dia_pad_pp_rhs,
                  dia_pad_x, dia_pad_xt, dia_power_data, dia_power_ok, dia_power_tile,
                  dia_pp_tile, dia_to_coo, dia_transpose,
                  frobenius_sq_minus_identity_dia, spgemm_dia, spmm_dia, spmm_dia_t,
                  spmm_dia_t_padded, spmm_dia_t_rows, spmv_dia, spmv_dia_cheby,
                  spmv_dia_padded, spmv_dia_padded_io, spmv_dia_pingpong, spmv_dia_power,
                  spmv_dia_power_rhs, spmv_dia_ref)
from .gat_fused import (gat_tile_fused, gat_tile_fused_bwd,
                        gat_tile_fused_bwd_ref, gat_tile_fused_ref)
from .rcm import bandwidth, n_diagonals, permute, rcm_permutation, rcm_reorder
from .scan import linear_scan, suffix_logsumexp
from .segment import (RowPlan, SegBuckets, SegTiles, SrcWindows, build_seg_buckets,
                      build_seg_tiles, build_src_windows, from_tiles,
                      gather_rows_buckets, gather_rows_buckets_ref,
                      gather_rows_windows, gather_rows_windows_ref, row_plan,
                      scatter_rows_buckets, scatter_rows_buckets_ref,
                      scatter_rows_windows, scatter_rows_windows_ref,
                      segment_broadcast_tiles, segment_broadcast_tiles_ref,
                      segment_max_tiles_ref, segment_softmax_tiles,
                      segment_softmax_tiles_bwd, segment_softmax_tiles_bwd_ref,
                      segment_softmax_tiles_mh, segment_softmax_tiles_ref,
                      segment_sum_tiles, segment_sum_tiles_ref, to_tiles)

__all__ = [
    "BELL", "csr_to_bell", "spmm_bell", "spmm_bell_ref", "spmv_bell",
    "DIA", "coo_to_dia", "dia_astype", "dia_pad_io", "dia_pad_pp", "dia_pad_pp_rhs",
    "dia_pad_x",
    "dia_pad_xt", "dia_power_data", "dia_power_ok", "dia_power_tile", "dia_pp_tile",
    "dia_to_coo", "dia_transpose", "frobenius_sq_minus_identity_dia",
    "spgemm_dia", "spmm_dia", "spmm_dia_t", "spmm_dia_t_padded", "spmm_dia_t_rows",
    "spmv_dia", "spmv_dia_cheby", "spmv_dia_padded", "spmv_dia_padded_io",
    "spmv_dia_pingpong", "spmv_dia_power", "spmv_dia_power_rhs", "spmv_dia_ref",
    "gat_tile_fused", "gat_tile_fused_bwd", "gat_tile_fused_bwd_ref",
    "gat_tile_fused_ref", "bandwidth", "n_diagonals", "permute",
    "rcm_permutation", "rcm_reorder", "linear_scan",
    "suffix_logsumexp", "RowPlan", "SegBuckets", "SegTiles", "SrcWindows",
    "build_seg_buckets", "build_seg_tiles", "build_src_windows",
    "gather_rows_buckets", "gather_rows_buckets_ref", "gather_rows_windows",
    "gather_rows_windows_ref", "row_plan", "scatter_rows_buckets",
    "scatter_rows_buckets_ref", "scatter_rows_windows", "scatter_rows_windows_ref",
    "to_tiles", "from_tiles",
    "segment_broadcast_tiles", "segment_broadcast_tiles_ref", "segment_max_tiles_ref",
    "segment_softmax_tiles", "segment_softmax_tiles_bwd", "segment_softmax_tiles_bwd_ref",
    "segment_softmax_tiles_mh", "segment_softmax_tiles_ref",
    "segment_sum_tiles", "segment_sum_tiles_ref",
]
