"""repro_torch.sparse_api — the sparse front-end on the card.

    >>> import repro_torch.sparse_api as sp
    >>> A = sp.from_sparse_matrix(a)               # pack -> cuda
    >>> y = sp.spmm(A, b, c, alpha=1.0, beta=0.5)  # Sextans kernel
    >>> y = A @ b                                  # operator sugar
    >>> P = sp.plan(A_host, n, device_bytes=4 << 30)  # out of core if needed
    >>> y = P.run(b, c, 1.0, 0.5)

``device="cpu"`` keeps the packed tensor on the host, where the kernel
backends run their kernels' plain versions.
"""

from .backends import (
    SKINNY_N_MAX,
    Backend,
    StreamOps,
    get_backend,
    list_backends,
    register_backend,
    resolve_backend,
    set_auto_policy,
    skinny_n_max,
    stream_finish,
)
from .ops import spmm, spmm_raw, spmm_streaming
from .plan import (
    PLAN_STATS,
    SpmmPlan,
    StreamingPlan,
    device_memory_budget,
    plan,
)
from .tensor import (
    Format,
    PackedSpMM,
    SparseTensor,
    from_coo,
    from_dense,
    from_reference_arrays,
    from_sparse_matrix,
    pack_hflex,
)

__all__ = [
    "Format",
    "SparseTensor",
    "PackedSpMM",
    "spmm",
    "spmm_raw",
    "spmm_streaming",
    "plan",
    "SpmmPlan",
    "StreamingPlan",
    "PLAN_STATS",
    "device_memory_budget",
    "from_coo",
    "from_dense",
    "from_reference_arrays",
    "from_sparse_matrix",
    "pack_hflex",
    "Backend",
    "StreamOps",
    "stream_finish",
    "register_backend",
    "get_backend",
    "list_backends",
    "resolve_backend",
    "set_auto_policy",
    "SKINNY_N_MAX",
    "skinny_n_max",
]
