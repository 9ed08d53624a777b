"""Row-sparse gradients of the port (``paddle_tpu/framework/selected_rows.py``).

:class:`SelectedRows` is the container (rows and a value block of a
``[height, ...]`` tensor, duplicate rows summing). The eager optimizer
contract rides on it: ``Embedding(sparse=True)`` and ``ShardedEmbedding``
record the rows each forward looks up (:func:`record_rows`), and ``SGD``,
``Adam(lazy_mode=True)`` and ``RowSparseAdam`` update only those rows in
their next ``step()`` (:func:`take_pending_rows`).

The reference records nothing while JAX traces a compiled step
(``is_traced_value``). The port traces nothing, so
:class:`paddle_tpu_torch.jit.TrainStep` runs its forward and backward inside
:func:`compiled_step`, and the layers that record rows ask
:func:`in_compiled_step`: inside a step they record nothing (no host sync on
the ids, no pending rows that no ``step()`` drains, no eager row count), and
``embedding`` gives the zero row for an out-of-range id instead of raising.
"""
from __future__ import annotations

import contextlib
import threading

import torch

# process-wide, not per thread: a recomputed forward runs inside the
# backward, on autograd's device thread
_scope_lock = threading.Lock()
_scope_depth = 0


@contextlib.contextmanager
def compiled_step():
    """The scope of a ``TrainStep``'s forward and backward."""
    global _scope_depth
    with _scope_lock:
        _scope_depth += 1
    try:
        yield
    finally:
        with _scope_lock:
            _scope_depth -= 1


def in_compiled_step() -> bool:
    """Whether a :func:`compiled_step` scope is open."""
    return _scope_depth > 0


class SelectedRows:
    """Rows + values view of a ``[height, ...]`` tensor: row ``rows[i]``
    holds ``values[i]``; unlisted rows are zero. Duplicate rows are allowed
    and sum (the reference's MergeAdd semantics). The sums are
    ``index_put_(accumulate=True)``, deterministic on the card."""

    def __init__(self, rows, values, height: int):
        self._values = torch.as_tensor(values)
        self._rows = torch.as_tensor(rows, dtype=torch.int64, device=self._values.device)
        if self._rows.ndim != 1 or self._values.shape[0] != self._rows.shape[0]:
            raise ValueError(f"rows {tuple(self._rows.shape)} vs values {tuple(self._values.shape)}")
        self._height = int(height)

    @property
    def rows(self):
        return self._rows

    @property
    def values(self):
        return self._values

    @property
    def height(self):
        return self._height

    def merge_add(self) -> "SelectedRows":
        """Coalesce duplicate rows by summation, rows ascending."""
        uniq, inv = torch.unique(self._rows, return_inverse=True)
        summed = self._values.new_zeros((uniq.shape[0],) + tuple(self._values.shape[1:]))
        summed.index_put_((inv,), self._values, accumulate=True)
        return SelectedRows(uniq, summed, self._height)

    def to_dense(self):
        dense = self._values.new_zeros((self._height,) + tuple(self._values.shape[1:]))
        return dense.index_put_((self._rows,), self._values, accumulate=True)

    @staticmethod
    def from_dense(dense, rows, height=None) -> "SelectedRows":
        dense = torch.as_tensor(dense)
        rows = torch.as_tensor(rows, dtype=torch.int64, device=dense.device)
        return SelectedRows(rows, dense[rows], dense.shape[0] if height is None else height)

    def __repr__(self):
        return (f"SelectedRows(height={self._height}, nnz_rows={int(self._rows.shape[0])}, "
                f"dim={tuple(self._values.shape[1:])})")


def record_rows(param, ids) -> None:
    """Note the rows ``ids`` touched this forward on the weight ``param``;
    the next eager optimizer step takes (and clears) them."""
    rows = torch.unique(torch.as_tensor(ids).reshape(-1)).to(torch.int64)
    param.__dict__.setdefault("_sparse_rows_pending", []).append(rows)


def take_pending_rows(param):
    """The unique rows recorded on ``param`` since the last take (an int64
    tensor, ascending), or None; clears them."""
    pend = param.__dict__.get("_sparse_rows_pending")
    if not pend:
        return None
    rows = torch.unique(torch.cat(pend))
    pend.clear()
    return rows
