"""Exact weight-table lookups on ``[M, R]`` (slot, replica) index grids.

Every lookup keyed by (bond, substate) selects original f32 table entries,
so the fast diagonal, cluster and loop updates stay bit-identical to their
sequential references.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def bond_fetch(tab: jnp.ndarray, idx: jnp.ndarray):
    """``tab[idx]`` as int32 for a small per-bond int table ``tab[NB]`` and
    an index grid ``idx i32[E, R]``."""
    return tab.astype(jnp.int32)[idx]


def fetch_xor(bond_xor: jnp.ndarray, b: jnp.ndarray):
    """Per-replica sign-pattern mask ``bond_xor[r, b[.., r]]`` for a
    ``[R, NB]`` table and ``b i32[M, R]`` (see ``diagonal._xor_si``)."""
    R = bond_xor.shape[0]
    rows = jnp.arange(R, dtype=jnp.int32)
    return bond_xor[rows.reshape((1,) * (b.ndim - 1) + (-1,)), b]


def class_select(wtab: jnp.ndarray, cls_idx: jnp.ndarray,
                 col_idx: jnp.ndarray):
    """``wtab[cls, col]`` via a compare-select chain over the C*S cells —
    exact (selects original f32 entries), gather-free, lane-parallel. Only
    worthwhile for small tables; callers gate on ``wtab.size``."""
    C, S = wtab.shape
    flat = wtab.reshape(-1)
    code = cls_idx * S + col_idx
    out = jnp.broadcast_to(flat[0], code.shape)
    for j in range(1, C * S):
        out = jnp.where(code == j, flat[j], out)
    return out

# Above this many columns the where-chain costs more than the scalarized
# gather it replaces; fall back to direct indexing.
_MAX_COLS = 64


def row_select(table: jnp.ndarray, row_idx: jnp.ndarray, col_idx: jnp.ndarray):
    """``table[row_idx, col_idx]`` via one row gather + a column select
    chain. ``table: [T, C]``; ``row_idx``/``col_idx`` broadcast-compatible
    integer grids. Exact: selects original table entries."""
    C = table.shape[-1]
    if C > _MAX_COLS:
        return table[row_idx, col_idx]
    rows = table[row_idx]  # [..., C] row gather
    out = rows[..., 0]
    for c in range(1, C):
        out = jnp.where(col_idx == c, rows[..., c], out)
    return out


def searchsorted_left(table: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    """``jnp.searchsorted(table, q, side='left')`` as int32 for a sorted f32
    table ``[NB]``, or per replica for ``[R, NB]`` tables against the
    columns of ``q[M, R]`` (heat-bath proposal sampling,
    ``heatbath.rs:148-209``)."""
    if table.ndim == 2:
        return jax.vmap(
            lambda t, qq: jnp.searchsorted(t, qq), in_axes=(0, 1), out_axes=1,
        )(table, q).astype(jnp.int32)
    return jnp.searchsorted(table, q).astype(jnp.int32)


def row_select3(table: jnp.ndarray, b_idx, i_idx, j_idx):
    """``table[b, i, j]`` for a [T, C, C] table (e.g. ``full_w``) via the
    flattened-column :func:`row_select`."""
    T, C, C2 = table.shape
    return row_select(table.reshape(T, C * C2), b_idx, i_idx * C2 + j_idx)
