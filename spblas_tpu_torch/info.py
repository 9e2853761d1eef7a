"""Operation info objects — counterpart of ``spblas_tpu/info.py``: the
result of an inspect/compute phase, carrying ``result_shape`` and
``result_nnz`` plus an opaque plan."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple


@dataclasses.dataclass
class OperationInfo:
    """Result of an *_inspect / *_compute symbolic phase; ``result_nnz``
    is a host integer."""

    result_shape: Tuple[int, ...]
    result_nnz: int
    # suggested padded capacity for the output (power-of-two bucket)
    result_capacity: Optional[int] = None
    # opaque backend plan
    plan: Any = None
    # opaque reuse state
    state: Any = None

    def update(self, **kw) -> "OperationInfo":
        return dataclasses.replace(self, **kw)
