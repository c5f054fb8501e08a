"""Block-ELL sparse × dense products (counterpart of
``gflownet_spai_tpu/ops/bsr.py``).

Matrices whose nonzeros cluster into dense (bm × bn) blocks are stored
block-ELL: ``data`` [n_block_rows, W, bm, bn] with W the longest block
row's block count, and ``bcols`` int32 [n_block_rows, W] block-column ids.
Padded blocks point at block-column 0 with zero data, so they add nothing
and need no mask.

``spmm_bell`` launches K17 on CUDA tensors.  One kernel design serves
both TPU variants, the streamed ``_spmm_bell_pallas`` and the X-resident
``_spmm_bell_pallas_resident``: their split is a VMEM matter
(``_resident_bk`` is kept verbatim so the regime JAX would pick can be
named).  CPU tensors take the plain version ``spmm_bell_ref``.

The dtype rule (blocks, X → output, and the kernel that runs on the card):

- float32, float32 → float32: ``bell_spmm`` (``csrc/bsr.cu``), float32
  FMAs on CUDA cores;
- bf16, float32 → float32: the same kernel's bf16-block instance, which
  widens each bf16 word to float32 and runs the same FMAs in the same
  order (the float32 instance's bits on ``data.float()``);
- float32, bf16 → float32: X is promoted to float32 first, as
  ``spmm_bell_jnp`` promotes it, and the float32 instance runs;
- bf16, bf16 → bf16: ``bell_spmm_bf16`` (``csrc/bsr_bf16.cu``), wgmma
  on bf16 with float32 accumulators, fed by TMA, over the BELL's chunk list
  (``_chunk_list``: per block row its [bm, 32] chunks that hold a word other
  than zero, made once per BELL's data) in column tiles of ``_col_tile``;
- any other dtype (float16, float64, …) raises ``ValueError`` on the card.

Every product and sum is float32, and the output is rounded once, where it
is stored: the output dtype is promote(blocks, X), ``spmm_bell_jnp``'s.
The JAX TPU kernels differ: both store the blocks' dtype whatever X is
(bf16 blocks with float32 X give bf16), and the streamed one sums its W
block products in the bf16 output block.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Any, Tuple

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from .. import _build
from ..sparse.ops import f32_exact
from ..sparse.types import CSR, Shape, to_numpy
from .dia import _data_version

_BMS = (8, 16, 32, 64, 128)   # block heights the kernel is built for
_BN_STEP = 32                 # block widths: multiples of the kernel's staged chunk
_MAX_K = 65535 * 128          # the kernel's grid holds 65,535 tiles of 128 columns
_REF_WORDS = 1 << 28          # plain version: gathered X words per chunk of block rows
# The kernels' (blocks, X) dtypes: the instance code, and each instance's
# name in ``spmm_bell.type_launches``
_TYPES = {(torch.float32, torch.float32): 0, (torch.bfloat16, torch.float32): 1,
          (torch.bfloat16, torch.bfloat16): 2}
_TYPE_NAMES = ("float32", "bf16 blocks, float32 X", "bf16 blocks, bf16 X")
# (data, bcols, nbr, W, bm, bn, x, K, y, vec) of the CUDA-core entry point
_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
             + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int])
# (data, bcols, list, nbr, W, bm, bn, x, n, K, y, kc, tma, stream) of the
# tensor-core one
_ARGTYPES_BF16 = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                  + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                     ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
_CHUNK = 32           # the columns of a block in one chunk: a wgmma's two k16 steps
_SMS = 132            # the H100's SMs
_COL_TILES = (256, 128, 64)   # the tensor-core kernel's column tiles Kc
_ENCODE_ERROR = 1000  # its return code for a tensor-map encode that failed, + the CUresult


@dataclasses.dataclass(frozen=True)
class BELL:
    """Block-ELL sparse matrix: ``data`` [nbr, W, bm, bn], ``bcols`` int32
    [nbr, W], as numpy arrays (host) or torch tensors (``.to(device)``)."""

    data: Any
    bcols: Any
    shape: Shape
    nnz: int
    # the tensor-core K17's chunk list (``_chunk_list``), made with a BELL of
    # bf16 blocks on the card (None otherwise: ``_chunks`` makes it on
    # demand), and the version of ``data`` it was made from (``_chunks``
    # makes it again after an in-place write)
    chunks: Any = dataclasses.field(init=False, repr=False, compare=False)
    chunks_version: int | None = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        # Made with the matrix, never in a kernel call: a CUDA-graph capture
        # of a call then holds no list build.
        made = isinstance(self.data, torch.Tensor) and self.data.is_cuda \
            and self.data.dtype == torch.bfloat16 and self.data.dim() == 4
        object.__setattr__(self, "chunks", _chunk_list(self.data) if made else None)
        object.__setattr__(self, "chunks_version", _data_version(self.data) if made else None)

    @property
    def blockshape(self) -> Tuple[int, int]:
        return (int(self.data.shape[2]), int(self.data.shape[3]))

    @property
    def width(self) -> int:
        return int(self.data.shape[1])

    def to(self, device) -> "BELL":
        """Torch tensors on ``device`` (``bcols`` stays int32, the kernel's
        index type; bf16 ``data`` is a torch tensor already, numpy has no
        bf16)."""
        data = self.data.to(device) if isinstance(self.data, torch.Tensor) \
            else torch.as_tensor(to_numpy(self.data), device=device)
        return dataclasses.replace(
            self, data=data, bcols=torch.as_tensor(to_numpy(self.bcols), dtype=torch.int32,
                                                   device=device))

    def todense(self) -> torch.Tensor:
        data = torch.as_tensor(self.data)
        nbr, W, bm, bn = data.shape
        bcols = torch.as_tensor(self.bcols, device=data.device).long()
        out = data.new_zeros((nbr, self.shape[1] // bn, bm, bn))
        rows = torch.arange(nbr, device=data.device)[:, None].expand(nbr, W)
        out.index_put_((rows.reshape(-1), bcols.reshape(-1)),
                       data.reshape(-1, bm, bn), accumulate=True)
        return out.permute(0, 2, 1, 3).reshape(self.shape)


def _chunk_list(data: torch.Tensor) -> torch.Tensor:
    """The tensor-core K17's chunk list of blocks ``data`` [nbr, W, bm, bn]:
    int32 [nbr, 1 + W·bn/32], per block row the count of its [bm, 32]
    chunks that hold a word other than zero (NaN counts, -0.0 does not),
    then their indices w·bn/32 + j in slot order (the row's other indices
    follow, unread).  The kernel multiplies the listed chunks alone, so an
    all-zero chunk adds nothing whatever X holds under it.  Device ops
    only, no host sync: a CUDA-graph capture may make a BELL."""
    nbr, W, bm, bn = data.shape
    C = W * (bn // _CHUNK)
    # a block column's least and largest word over the bm rows (one pass,
    # coalesced across columns): not both zero where a word is other than
    # zero, NaN where one is NaN
    lo, hi = torch.aminmax(data.detach().reshape(nbr * W, bm, bn), dim=1)
    listed = ((lo != 0) | (hi != 0)).reshape(nbr, C, _CHUNK).any(-1)
    count = listed.sum(1, dtype=torch.int32)
    # each index's place: the listed ones first, the others after, both in
    # slot order (a permutation, so the scatter writes every place once)
    place = torch.where(listed, listed.cumsum(1, dtype=torch.int32),
                        count[:, None] + (~listed).cumsum(1, dtype=torch.int32))
    out = torch.empty((nbr, 1 + C), dtype=torch.int32, device=data.device)
    out[:, 0] = count
    out.scatter_(1, place.long(), torch.arange(C, dtype=torch.int32, device=data.device)
                 .expand(nbr, C))
    return out


def _chunks(a: BELL) -> torch.Tensor:
    """``a.chunks``, made where ``a`` was made without it (host or float32
    blocks moved or cast since) or ``a.data`` was written in place since it
    was made (its version counter moved; an inference tensor keeps none, so
    its list is made at every call).  A list made while a CUDA graph is
    captured holds its values only in its replays, so it is not kept."""
    version = _data_version(a.data)
    if a.chunks is not None and version is not None and version == a.chunks_version:
        return a.chunks
    chunks = _chunk_list(a.data)
    if not (a.data.is_cuda and torch.cuda.is_current_stream_capturing()):
        object.__setattr__(a, "chunks", chunks)
        object.__setattr__(a, "chunks_version", version)
    return chunks


def _col_tile(nbr: int, K: int, tma: bool) -> int:
    """The X columns Kc a block of the tensor-core K17 takes: the widest of
    ``_COL_TILES`` (256: A read once at K <= 256) no wider than K's 64-column
    tiles whose grid of nbr·ceil(K / Kc) blocks still gives every SM of the
    card a block, else 64; 64 where X goes without TMA (``tma`` false).  On
    an H100 it picks the fastest of the three at every ``chip_smoke.py``
    ``[bell]`` shape."""
    if tma:
        for kc in _COL_TILES[:-1]:
            if kc <= -(-K // 64) * 64 and nbr * -(-K // kc) >= _SMS:
                return kc
    return _COL_TILES[-1]


def kernel_config(bm: int, kc: int) -> dict:
    """The tensor-core K17's shape at block height bm and column tile kc
    (``csrc/bsr_bf16.cu`` ``Cfg``): threads a block, ring stages, dynamic
    shared memory bytes, and the registers setmaxnreg gives a producer and
    a consumer thread.  Needs the built kernel (a CUDA machine)."""
    fn = _build.load("bsr_bf16").bell_spmm_bf16_config
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    _build.check(fn(bm, kc, out), "kernel_config")
    return dict(zip(("threads", "stages", "smem", "producer_regs", "consumer_regs"), out))


def csr_to_bell(csr: CSR, blockshape=(8, 128)) -> BELL:
    """Host-side conversion (the pattern is static, so it runs once);
    returns a numpy-backed BELL."""
    bm, bn = blockshape
    m, n = csr.shape
    if m % bm or n % bn:
        raise ValueError(f"shape {csr.shape} not divisible by block {blockshape}")
    indptr = to_numpy(csr.indptr)
    indices = to_numpy(csr.indices)
    data = to_numpy(csr.data)
    counts = np.diff(indptr)
    row = np.repeat(np.arange(m, dtype=np.int64), counts)
    brow, bcol = row // bm, indices // bn
    key = brow * (n // bn) + bcol
    uniq, inv = np.unique(key, return_inverse=True)
    ub_row = (uniq // (n // bn)).astype(np.int64)
    ub_col = (uniq % (n // bn)).astype(np.int64)
    per_row = np.bincount(ub_row, minlength=m // bm)
    W = max(1, int(per_row.max()))
    nbr = m // bm
    bell_data = np.zeros((nbr, W, bm, bn), data.dtype)
    bell_cols = np.zeros((nbr, W), np.int32)
    slot_of_block = np.zeros(len(uniq), np.int64)
    next_slot = np.zeros(nbr, np.int64)
    for b in np.argsort(ub_row, kind="stable"):
        r = ub_row[b]
        slot_of_block[b] = next_slot[r]
        bell_cols[r, next_slot[r]] = ub_col[b]
        next_slot[r] += 1
    bell_data[ub_row[inv], slot_of_block[inv], row % bm, indices % bn] = data
    return BELL(data=bell_data, bcols=bell_cols, shape=csr.shape, nnz=int(len(data)))


def spmm_bell_ref(a: BELL, x: torch.Tensor) -> torch.Tensor:
    """Plain version of K17 (the JAX package's ``spmm_bell_jnp``): gather
    the X blocks each block row needs and multiply them batched, in full
    float32 (bf16 blocks and X widened first), rounded once to
    promote(blocks, X).  Block rows go in chunks, so the gathered blocks
    stay under ``_REF_WORDS`` words."""
    nbr, W, bm, bn = a.data.shape
    K = x.shape[1]
    out = torch.promote_types(a.data.dtype, x.dtype)
    acc = torch.promote_types(out, torch.float32)
    data = a.data.to(acc)
    xb = x.to(acc).reshape(-1, bn, K)
    bcols = a.bcols.long()
    step = max(1, _REF_WORDS // (W * bn * K))
    parts = []
    with f32_exact():
        for r0 in range(0, nbr, step):
            g = xb[bcols[r0:r0 + step]]                     # [r, W, bn, K]
            parts.append(torch.einsum("rwij,rwjk->rik", data[r0:r0 + step], g))
    return torch.cat(parts).reshape(nbr * bm, K).to(out)


_BELL_VMEM_BUDGET = 10 * 1024 * 1024   # X-tile budget of the TPU's 16 MiB/core


def _resident_bk(a: BELL, K: int) -> int | None:
    """Largest 128-multiple K-tile whose [n, bk] X column tile fits the TPU
    kernel's VMEM budget (None: X is too tall even at bk = 128, and JAX
    takes the streamed kernel)."""
    n = a.shape[1]
    for bk in (512, 384, 256, 128):
        if K % bk == 0 and n * bk * 4 <= _BELL_VMEM_BUDGET:
            return bk
    return None


_BCOLS_CHECKED = WeakIdKeyDictionary()   # bcols tensor → its ids are in range


def _check(a: BELL, x: torch.Tensor) -> int:
    """The kernels take contiguous tensors on X's device, of the dtypes of
    ``_TYPES``.  Returns the instance's code."""
    for t, what in ((a.data, "data"), (a.bcols, "bcols"), (x, "X")):
        if not isinstance(t, torch.Tensor) or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"spmm_bell: {what} must be a contiguous tensor on "
                             f"{x.device} (BELL.to(device))")
    code = _TYPES.get((a.data.dtype, x.dtype))
    if code is None:
        raise ValueError(f"spmm_bell: blocks {a.data.dtype} with X {x.dtype}: the kernels "
                         "take float32 or bfloat16 blocks with float32 X, or bfloat16 "
                         "blocks with bfloat16 X (float32 blocks promote a bfloat16 X)")
    nbr, W, bm, bn = a.data.shape
    if a.bcols.dtype != torch.int32 or tuple(a.bcols.shape) != (nbr, W):
        raise ValueError(f"spmm_bell: bcols must be int32 [{nbr}, {W}]")
    if bm not in _BMS or bn % _BN_STEP or x.dim() != 2 or x.shape[0] != a.shape[1] \
            or not 1 <= x.shape[1] <= _MAX_K or nbr * bm != a.shape[0] \
            or a.shape[1] % bn:
        raise ValueError(f"spmm_bell: the kernel takes bm in {_BMS}, bn a multiple of "
                         f"{_BN_STEP} and X [{a.shape[1]}, 1 <= K <= {_MAX_K}]; got "
                         f"blocks {(bm, bn)}, X {tuple(x.shape)}")
    # the kernel reads X rows bcols·bn .. + bn: ids out of range would read
    # outside X (checked once per bcols tensor; the pattern is static)
    if a.bcols not in _BCOLS_CHECKED:
        _BCOLS_CHECKED[a.bcols] = a.bcols.numel() == 0 or bool(
            (a.bcols.min() >= 0) & (a.bcols.max() < a.shape[1] // bn))
    if not _BCOLS_CHECKED[a.bcols]:
        raise ValueError(f"spmm_bell: bcols holds block-column ids outside "
                         f"[0, {a.shape[1] // bn})")
    return code


def spmm_bell(a: BELL, x: torch.Tensor) -> torch.Tensor:
    """Y = A·X for dense X [n, K] → [m, K] in promote(blocks, X).  K17 on
    CUDA tensors (the module docstring's dtype rule names the kernel),
    ``spmm_bell_ref`` on CPU tensors.

    The kernels skip the products of every all-zero [bm, 32] chunk of A
    (padded slots, zero blocks).  So where X holds inf or NaN in the rows
    under such a chunk, the kernel's sum stays finite and the plain
    version's is NaN (0·inf); for finite X the two agree to rounding."""
    if x.device.type == "cpu":
        return spmm_bell_ref(a, x)
    if isinstance(a.data, torch.Tensor) and a.data.dtype == torch.float32 \
            and x.dtype == torch.bfloat16:
        x = x.float()
    code = _check(a, x)
    nbr, W, bm, bn = a.data.shape
    K = x.shape[1]
    # the kernels read A as 16-byte words: a view at an unaligned offset is copied
    data = a.data if a.data.data_ptr() % 16 == 0 else a.data.clone()
    y = torch.empty((a.shape[0], K), dtype=x.dtype, device=x.device)
    # 16-byte X and Y rows: K a multiple of a 16-byte word's elements (for
    # bf16 X also what TMA needs to take X)
    vec = K % (16 // x.element_size()) == 0 and x.data_ptr() % 16 == 0
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if code == 2:       # bf16 x bf16: the tensor-core kernel over the chunk list
        if nbr * W * bm > 2**31 - 1 or x.shape[0] > 2**31 - 1:
            raise ValueError(f"spmm_bell: the tensor-core kernel takes fewer than 2^31 "
                             f"block rows x slots x bm ({nbr * W * bm}) and X rows")
        chunks = _chunks(a)
        if chunks.device != x.device or tuple(chunks.shape) != (nbr, 1 + W * bn // _CHUNK):
            raise ValueError(f"spmm_bell: chunk list {tuple(chunks.shape)} on "
                             f"{chunks.device}; the kernel reads [{nbr}, "
                             f"{1 + W * bn // _CHUNK}] on {x.device}")
        fn = _build.load("bsr_bf16").bell_spmm_bf16
        fn.argtypes, fn.restype = _ARGTYPES_BF16, ctypes.c_int
        rc = fn(data.data_ptr(), a.bcols.data_ptr(), chunks.data_ptr(), nbr, W, bm, bn,
                x.data_ptr(), x.shape[0], K, y.data_ptr(), _col_tile(nbr, K, vec), int(vec),
                stream)
        if rc >= _ENCODE_ERROR:
            raise RuntimeError(f"spmm_bell: cuTensorMapEncodeTiled failed (CUresult "
                               f"{rc - _ENCODE_ERROR})")
    else:               # the CUDA-core kernel's float32 or bf16-block instance
        fn = _build.load("bsr").bell_spmm
        fn.argtypes, fn.restype = _ARGTYPES + [ctypes.c_int, ctypes.c_void_p], ctypes.c_int
        rc = fn(data.data_ptr(), a.bcols.data_ptr(), nbr, W, bm, bn, x.data_ptr(), K,
                y.data_ptr(), int(vec), code, stream)
    _build.check(rc, "spmm_bell")
    spmm_bell.launches += 1
    spmm_bell.type_launches[_TYPE_NAMES[code]] += 1
    return y


def spmv_bell(a: BELL, x: torch.Tensor) -> torch.Tensor:
    """y = A·x through the SpMM with one right-hand side."""
    return spmm_bell(a, x[:, None])[:, 0]


spmm_bell.launches = 0
spmm_bell.type_launches = dict.fromkeys(_TYPE_NAMES, 0)   # by (blocks, X) dtypes
