"""Hamiltonian bond tables — the batched replacement for the reference's
``Hamiltonian`` trait / ``Ham`` closure adapter (``src/sse/ham.rs:4-45``,
``src/sse/qmc_traits/diagonal.rs:5-12``).

Where the reference evaluates matrix elements through closures per op, this
build precompiles every bond's diagonal matrix elements into a dense table
``diag_w[NB, 2^K]`` (and optionally the full ``2^K x 2^K`` matrices for
directed-loop updates), so the hot update loops are pure gathers.

Substate indexing convention: bit ``l`` of the substate index is the spin of
the variable in leg slot ``l`` (bit 0 = slot 0). Site bonds occupy slot 0 and
pad slot 1 with var ``-1``; their table rows are constant in bit 1.

TFIM bond layout mirrors ``src/sse/qmc_ising.rs:186-205``:
``[0, NE)`` two-site bonds, ``[NE, NE+N)`` transverse-field site bonds
(constant ops = cluster edges), ``[NE+N, NE+2N)`` longitudinal site bonds.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from isingmontecarlo_tpu.lattice import Edge, nvars_from_edges


@jax.tree_util.register_pytree_node_class
class BondModel:
    """Compiled Hamiltonian: static tables indexed by bond id.

    Shapes: ``NB`` bonds, ``K`` max legs per bond (2 for TFIM), ``N`` spins.
    The weight tables are pytree leaves (traced under jit); ``offset`` and
    ``nvars`` are static aux data so they stay Python scalars inside jit.
    """

    def __init__(self, bond_vars, is_constant, diag_w, full_w, offset, nvars,
                 cls=None, wtab=None, cls_full=None, wtab_full=None):
        self.bond_vars = bond_vars  # i32[NB, K], -1 pads unused legs
        self.is_constant = is_constant  # bool[NB] (op_container.rs:90-93)
        self.diag_w = diag_w  # f32[NB, 2^K]
        self.full_w = full_w  # f32[NB, 2^K, 2^K] or None
        self.offset = offset  # energy offset from the weight shifts
        self.nvars = nvars
        # Weight-class tables (see :func:`class_tables`): ``cls i32[NB]`` maps
        # each bond to its distinct-``diag_w``-row class, ``wtab f32[C, 2^K]``
        # holds the distinct rows, so ``diag_w[b, s] == wtab[cls[b], s]``
        # exactly. The diagonal update's fast path uses them to replace
        # weight-table gathers with a tiny select chain.
        self.cls = cls
        self.wtab = wtab
        # Same factorization over flattened ``full_w`` rows (cluster/loop
        # updates look up ``full_w[b, si, so]``).
        self.cls_full = cls_full
        self.wtab_full = wtab_full  # f32[C2, 2^K * 2^K]

    def tree_flatten(self):
        children = (self.bond_vars, self.is_constant, self.diag_w,
                    self.full_w, self.cls, self.wtab, self.cls_full,
                    self.wtab_full)
        return children, (self.offset, self.nvars)

    @classmethod
    def tree_unflatten(cls, aux, children):
        (bond_vars, is_constant, diag_w, full_w, bcls, wtab, cls_full,
         wtab_full) = children
        offset, nvars = aux
        return cls(bond_vars, is_constant, diag_w, full_w, offset, nvars,
                   cls=bcls, wtab=wtab, cls_full=cls_full,
                   wtab_full=wtab_full)

    @property
    def nbonds(self) -> int:
        return self.bond_vars.shape[0]

    @property
    def max_legs(self) -> int:
        return self.bond_vars.shape[1]

    def arity(self) -> jax.Array:
        """i32[NB] number of valid legs per bond."""
        return jnp.sum(self.bond_vars >= 0, axis=1).astype(jnp.int32)

    def max_diag_w(self) -> jax.Array:
        """f32[NB]: max diagonal weight per bond (heat-bath ``BondWeights``,
        ``src/sse/qmc_traits/heatbath.rs:130-146``)."""
        return jnp.max(self.diag_w, axis=1)


def class_tables(diag_w: np.ndarray) -> tuple[jax.Array, jax.Array]:
    """Host-side weight-class factorization: group bonds by identical
    ``diag_w`` rows. Returns ``(cls i32[NB], wtab f32[C, 2^K])`` with
    ``diag_w[b] == wtab[cls[b]]`` bit-exactly (``wtab`` rows are copies of
    original rows, not recomputed). Must run outside jit (value-dependent)."""
    uq, inv = np.unique(np.asarray(diag_w), axis=0, return_inverse=True)
    return (
        jnp.asarray(inv.reshape(-1).astype(np.int32)),
        jnp.asarray(uq.astype(np.float32)),
    )


def two_site_diag_weight(j: float, s0: bool, s1: bool) -> float:
    """``|J| - J`` for aligned spins, ``|J| + J`` for anti-aligned
    (``qmc_ising.rs:863-874``)."""
    return abs(j) + (-j if s0 == s1 else j)


def longitudinal_diag_weight(h: float, s: bool) -> float:
    """``|h| + h`` spin-up, ``|h| - h`` spin-down (``qmc_ising.rs:880-888``)."""
    return abs(h) + (h if s else -h)


def tfim_model(
    edges: Sequence[tuple[Edge, float]],
    transverse: float,
    longitudinal: float = 0.0,
    nvars: int | None = None,
) -> BondModel:
    """Build the TFIM bond model
    ``H = sum_ij J_ij s^z_i s^z_j + G sum_i s^x_i (+ longitudinal site terms)``
    with the reference's bond layout and energy offset
    (``qmc_ising.rs:80-115, 186-205, 863-888``)."""
    if nvars is None:
        nvars = nvars_from_edges(edges)
    ne = len(edges)
    has_h = abs(longitudinal) > 1e-12
    nb = ne + nvars + (nvars if has_h else 0)
    K = 2

    bond_vars = np.full((nb, K), -1, dtype=np.int32)
    is_constant = np.zeros((nb,), dtype=bool)
    diag_w = np.zeros((nb, 1 << K), dtype=np.float32)
    # full matrices: needed only for directed-loop updates on TFIM; transverse
    # ops are the only off-diagonal entries.
    full_w = np.zeros((nb, 1 << K, 1 << K), dtype=np.float32)

    for b, ((va, vb), j) in enumerate(edges):
        bond_vars[b] = (va, vb)
        for s in range(4):
            w = two_site_diag_weight(j, bool(s & 1), bool(s & 2))
            diag_w[b, s] = w
            full_w[b, s, s] = w

    for v in range(nvars):
        b = ne + v
        bond_vars[b, 0] = v
        is_constant[b] = True
        # Transverse ops: weight `transverse` for every in/out combination of
        # leg 0 (qmc_ising.rs:876-878); bit 1 is padding and must not vary.
        for s in range(4):
            diag_w[b, s] = transverse
            for t in range(4):
                if (s & 2) == (t & 2):  # padding leg fixed
                    full_w[b, s, t] = transverse

    if has_h:
        for v in range(nvars):
            b = ne + nvars + v
            bond_vars[b, 0] = v
            for s in range(4):
                w = longitudinal_diag_weight(longitudinal, bool(s & 1))
                diag_w[b, s] = w
                full_w[b, s, s] = w

    # Energy offset: sum |J| + n (G + |h|)  (qmc_ising.rs:97-99).
    offset = float(sum(abs(j) for _, j in edges)) + nvars * (
        transverse + abs(longitudinal)
    )

    cls, wtab = class_tables(diag_w)
    cls_full, wtab_full = class_tables(full_w.reshape(len(full_w), -1))
    return BondModel(
        bond_vars=jnp.asarray(bond_vars),
        is_constant=jnp.asarray(is_constant),
        diag_w=jnp.asarray(diag_w),
        full_w=jnp.asarray(full_w),
        offset=offset,
        nvars=nvars,
        cls=cls,
        wtab=wtab,
        cls_full=cls_full,
        wtab_full=wtab_full,
    )


def generic_model(
    nvars: int,
    interactions: Sequence[tuple[np.ndarray, Sequence[int]]],
    offset: float = 0.0,
) -> BondModel:
    """Build a model from arbitrary k-local interaction matrices — the
    capability surface of ``Qmc::make_interaction`` (``qmc_runner.rs:112-156``).

    ``interactions`` is a list of ``(mat, vars)`` where ``mat`` is either a
    full ``2^k x 2^k`` matrix (row = outputs, col = inputs, reference bit
    order ``qmc_runner.rs:673-680``: first variable is the most significant
    bit) or a length-``2^k`` diagonal. All weights must be non-negative.
    """
    K = max(len(vars) for _, vars in interactions)
    nb = len(interactions)
    bond_vars = np.full((nb, K), -1, dtype=np.int32)
    is_constant = np.zeros((nb,), dtype=bool)
    diag_w = np.zeros((nb, 1 << K), dtype=np.float32)
    full_w = np.zeros((nb, 1 << K, 1 << K), dtype=np.float32)

    for b, (mat, vars) in enumerate(interactions):
        mat = np.asarray(mat, dtype=np.float64)
        k = len(vars)
        bond_vars[b, :k] = vars
        nstates = 1 << k

        def to_ref_bits(local_idx: int) -> int:
            # our bit l = slot l spin; reference: first var most significant.
            ref = 0
            for l in range(k):
                ref = (ref << 1) | ((local_idx >> l) & 1)
            return ref

        if mat.ndim == 1 or (mat.ndim == 2 and mat.shape[0] == 1):
            mat = mat.reshape(-1)
            if mat.shape[0] != nstates:
                raise ValueError(f"diagonal interaction len {mat.shape[0]} != 2^{k}")
            if np.any(mat < 0):
                raise ValueError("negative weights are not allowed")
            for s in range(nstates):
                for pad in range(1 << (K - k)):
                    idx = s | (pad << k)
                    w = float(mat[to_ref_bits(s)])
                    diag_w[b, idx] = w
                    full_w[b, idx, idx] = w
        else:
            if mat.shape != (nstates, nstates):
                raise ValueError(f"interaction shape {mat.shape} != (2^{k}, 2^{k})")
            if np.any(mat < 0):
                raise ValueError("negative weights are not allowed")
            for si in range(nstates):
                for so in range(nstates):
                    # reference index = (outputs << k) + inputs
                    w = float(mat[to_ref_bits(so), to_ref_bits(si)])
                    for pad in range(1 << (K - k)):
                        ii = si | (pad << k)
                        oo = so | (pad << k)
                        full_w[b, ii, oo] = w
                        if ii == oo:
                            diag_w[b, ii] = w
            is_constant[b] = bool(np.all(np.abs(mat - mat.flat[0]) < 1e-12))

    cls, wtab = class_tables(diag_w)
    cls_full, wtab_full = class_tables(full_w.reshape(len(full_w), -1))
    return BondModel(
        bond_vars=jnp.asarray(bond_vars),
        is_constant=jnp.asarray(is_constant),
        diag_w=jnp.asarray(diag_w),
        full_w=jnp.asarray(full_w),
        offset=offset,
        nvars=nvars,
        cls=cls,
        wtab=wtab,
        cls_full=cls_full,
        wtab_full=wtab_full,
    )
