"""Band statistics of a sparse pattern (counterpart of
``gflownet_spai_tpu/ops/rcm.py:19-30``); ``train.loop.setup`` reads them to
resolve ``env_format="auto"`` as the JAX package does.  The RCM reordering
itself comes with the DIA slice of the port."""

from __future__ import annotations

import numpy as np

from ..sparse.types import COO


def bandwidth(coo: COO) -> int:
    if coo.nnz == 0:
        return 0
    h = coo.numpy()
    return int(np.abs(h.row.astype(np.int64) - h.col.astype(np.int64)).max())


def n_diagonals(coo: COO) -> int:
    h = coo.numpy()
    return int(len(np.unique(h.col.astype(np.int64) - h.row.astype(np.int64))))
