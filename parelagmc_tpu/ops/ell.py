"""Static-sparsity matrix-free operators for batched accelerator code.

All sparse operators in this framework (mass matrices, incidence,
prolongators, reduced SPDE operators) have mesh-determined, sample-
independent sparsity. We store them in padded ELL form - per-row index and
value slabs of fixed width - so that applying them to a *batch* of vectors
is a gather + multiply + reduce, which XLA compiles into fused kernels with
fully static shapes. Duplicate (row, col) slots are allowed and simply
accumulate, which lets assembly skip any merging pass.

Two flavors:

* ELL            - fixed values (cols, vals). y = sum_k vals[r,k] * x[cols[r,k]].
* CoefELL        - per-sample piecewise-constant coefficient c:
                   y = sum_k c[cells[r,k]] * mvals[r,k] * x[cols[r,k]].
                   This is how the Darcy velocity mass matrix M(k) is
                   "re-assembled" per sample on device (the reference
                   re-assembles a CSR per sample on host,
                   /root/reference/src/DarcySolver.cpp:472-520).

Batching: x may have arbitrary leading batch dimensions; the dof axis is
always last. That keeps the batch contiguous in the minor-most memory
dimension after the gather.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np


class ELL(NamedTuple):
    cols: jnp.ndarray  # (n, K) int32
    vals: jnp.ndarray  # (n, K) dtype

    @property
    def n_rows(self) -> int:
        return self.cols.shape[0]


class CoefELL(NamedTuple):
    cols: jnp.ndarray  # (n, K) int32
    mvals: jnp.ndarray  # (n, K) dtype
    cells: jnp.ndarray  # (n, K) int32


def ell_apply(ell: ELL, x: jnp.ndarray) -> jnp.ndarray:
    """y[..., r] = sum_k vals[r, k] * x[..., cols[r, k]]."""
    gathered = jnp.take(x, ell.cols.reshape(-1), axis=-1)
    gathered = gathered.reshape(x.shape[:-1] + ell.cols.shape)
    return jnp.sum(gathered * ell.vals, axis=-1)


def coef_ell_apply(op: CoefELL, c: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """y[..., r] = sum_k c[..., cells[r,k]] * mvals[r,k] * x[..., cols[r,k]].

    `c` is the per-sample piecewise-constant coefficient, batched like `x`.
    """
    xg = jnp.take(x, op.cols.reshape(-1), axis=-1).reshape(
        x.shape[:-1] + op.cols.shape
    )
    cg = jnp.take(c, op.cells.reshape(-1), axis=-1).reshape(
        c.shape[:-1] + op.cells.shape
    )
    return jnp.sum(cg * op.mvals * xg, axis=-1)


class DiagCoef(NamedTuple):
    """Diagonal of a CoefELL operator: diag(c)[r] = sum_k c[cells[r,k]]*vals[r,k]."""

    cells: jnp.ndarray  # (n, Kd) int32
    vals: jnp.ndarray  # (n, Kd)

    def __call__(self, c: jnp.ndarray) -> jnp.ndarray:
        cg = jnp.take(c, self.cells.reshape(-1), axis=-1).reshape(
            c.shape[:-1] + self.cells.shape
        )
        return jnp.sum(cg * self.vals, axis=-1)


def pack_csr_to_ell(csr, dtype=jnp.float32, width: Optional[int] = None) -> ELL:
    """Pack a scipy CSR/COO matrix into a padded device ELL."""
    csr = csr.tocsr()
    n = csr.shape[0]
    counts = np.diff(csr.indptr)
    w = int(counts.max()) if n else 0
    if width is not None:
        if w > width:
            raise ValueError("requested ELL width too small")
        w = width
    cols = np.zeros((n, w), dtype=np.int32)
    vals = np.zeros((n, w), dtype=np.float64)
    for_rows = np.repeat(np.arange(n), counts)
    slots = np.arange(csr.indices.size) - np.repeat(csr.indptr[:-1], counts)
    cols[for_rows, slots] = csr.indices
    vals[for_rows, slots] = csr.data
    return ELL(jnp.asarray(cols), jnp.asarray(vals, dtype=dtype))


def pack_coef_ell(
    m_cols: np.ndarray, m_vals: np.ndarray, m_cells: np.ndarray, dtype=jnp.float32
) -> CoefELL:
    return CoefELL(
        jnp.asarray(m_cols, dtype=jnp.int32),
        jnp.asarray(m_vals, dtype=dtype),
        jnp.asarray(m_cells, dtype=jnp.int32),
    )


def coef_diag_structure(
    m_cols: np.ndarray, m_vals: np.ndarray, m_cells: np.ndarray, dtype=jnp.float32
) -> DiagCoef:
    """Extract the diagonal slots of a host-side coefficient-ELL."""
    n, K = m_cols.shape
    rows = np.arange(n)[:, None]
    # Fast path: build_mixed_level puts the (up to two) diagonal slots first.
    if (
        K >= 2
        and np.all((m_cols[:, :2] == rows) | (m_vals[:, :2] == 0.0))
        and np.all((m_cols[:, 2:] != rows) | (m_vals[:, 2:] == 0.0))
    ):
        vals01 = np.where(m_cols[:, :2] == rows, m_vals[:, :2], 0.0)
        return DiagCoef(
            jnp.asarray(m_cells[:, :2], dtype=jnp.int32),
            jnp.asarray(vals01, dtype=dtype),
        )
    is_diag = (m_cols == rows) & (m_vals != 0.0)
    kd = int(is_diag.sum(axis=1).max()) if n else 0
    r_idx, j_idx = np.nonzero(is_diag)
    # Slot of each diagonal entry within its row (entries are row-sorted).
    starts = np.concatenate([[0], np.cumsum(is_diag.sum(axis=1))[:-1]])
    slot = np.arange(r_idx.size) - starts[r_idx]
    cells = np.zeros((n, kd), dtype=np.int32)
    vals = np.zeros((n, kd), dtype=np.float64)
    cells[r_idx, slot] = m_cells[r_idx, j_idx]
    vals[r_idx, slot] = m_vals[r_idx, j_idx]
    return DiagCoef(jnp.asarray(cells), jnp.asarray(vals, dtype=dtype))
