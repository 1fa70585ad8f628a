"""Equivalence oracle for the precomputed-weights diagonal sweep.

The fast path (``_diagonal_update_fast``) must run the *identical* Markov
chain as the sequential scan (``_diagonal_update_scan``): a diagonal sweep
never changes worldline propagation (it only inserts/removes diagonal ops,
``diagonal.rs:141-191``), so per-slot proposal weights evaluated upfront
from flip parities must reproduce the scan's carried state exactly — same
uniforms, same acceptance arithmetic, bit-identical output strings.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from isingmontecarlo_tpu import lattice
from isingmontecarlo_tpu.sse import diagonal as _diag
from isingmontecarlo_tpu.sse.ising import QmcIsingGraph, multi_sweep


@pytest.mark.parametrize(
    "L,G,h,beta,heatbath,scaled",
    [
        (3, 1.0, 0.0, 1.0, False, False),
        (3, 0.7, 0.4, 1.5, False, False),
        (4, 1.2, 0.0, 0.8, True, False),
        (3, 1.0, 0.3, 1.0, True, False),
        (3, 1.0, 0.0, 1.0, False, True),
        (3, 1.0, 0.2, 1.0, True, True),
    ],
)
def test_fast_path_matches_scan(L, G, h, beta, heatbath, scaled):
    edges = lattice.frustrated_square(L, L)
    g = QmcIsingGraph(edges, transverse=G, longitudinal=h, replicas=8, seed=3)
    g.sse, _, _, _ = multi_sweep(g.sse, jnp.float32(beta), g.model, 10)
    g._maybe_grow()
    ops, state, model = g.sse.ops, g.sse.state, g.model
    bs = (
        jax.random.uniform(
            jax.random.key(L), (8, model.nbonds), minval=0.5, maxval=1.5
        )
        if scaled
        else None
    )
    hbt = _diag.make_heatbath_tables(model, bs) if heatbath else None
    key = jax.random.key(42)
    a = _diag._diagonal_update_scan(
        ops, state, jnp.float32(beta), key, model,
        hb=hbt, heatbath=heatbath, bond_scale=bs,
    )
    b = _diag._diagonal_update_fast(
        ops, state, jnp.float32(beta), key, model,
        hb=hbt, heatbath=heatbath, bond_scale=bs,
    )
    assert np.array_equal(np.asarray(a.bond), np.asarray(b.bond))
    assert np.array_equal(np.asarray(a.inputs), np.asarray(b.inputs))
    assert np.array_equal(np.asarray(a.outputs), np.asarray(b.outputs))


@pytest.mark.parametrize(
    "Lx,Ly,heatbath",
    [
        (4, 8, False),  # N = 32: exactly one parity word
        (5, 7, True),  # N = 35: a partial second word
        (8, 8, False),  # N = 64: two full words
    ],
)
def test_packed_branch_matches_scan(Lx, Ly, heatbath):
    """The precompute packs flip parities 32 variables to a word; at and
    around word boundaries the fast path stays bit-identical to the
    sequential scan."""
    edges = lattice.frustrated_square(Lx, Ly)
    g = QmcIsingGraph(edges, transverse=1.0, longitudinal=0.2, replicas=8,
                      seed=3)
    g.sse, _, _, _ = multi_sweep(g.sse, jnp.float32(1.0), g.model, 10)
    g._maybe_grow()
    ops, state, model = g.sse.ops, g.sse.state, g.model
    hbt = _diag.make_heatbath_tables(model) if heatbath else None
    key = jax.random.key(42)
    a = _diag._diagonal_update_scan(
        ops, state, jnp.float32(1.0), key, model, hb=hbt, heatbath=heatbath,
    )
    b = _diag._diagonal_update_fast(
        ops, state, jnp.float32(1.0), key, model, hb=hbt, heatbath=heatbath,
    )
    assert np.array_equal(np.asarray(a.bond), np.asarray(b.bond))
    assert np.array_equal(np.asarray(a.inputs), np.asarray(b.inputs))
    assert np.array_equal(np.asarray(a.outputs), np.asarray(b.outputs))


@pytest.mark.parametrize(
    "heatbath,replicas",
    [(False, 8), (True, 8), (False, 128)],
)
def test_carry_kernel_matches_scan(heatbath, replicas, fake_gpu):
    """The carry kernel's wrapper — packing, dispatch and unpacking, with
    the kernel replaced by its plain twin (the kernel itself is checked on
    the card, tests/test_gpu_kernels.py) — is bit-identical to the
    sequential carry scan."""
    edges = lattice.frustrated_square(4, 4)
    g = QmcIsingGraph(edges, transverse=1.0, replicas=replicas, seed=9)
    g.sse, _, _, _ = multi_sweep(g.sse, jnp.float32(1.2), g.model, 10)
    g._maybe_grow()
    ops, state, model = g.sse.ops, g.sse.state, g.model
    hbt = _diag.make_heatbath_tables(model) if heatbath else None
    key = jax.random.key(7)
    a = _diag._diagonal_update_scan(
        ops, state, jnp.float32(1.2), key, model, hb=hbt, heatbath=heatbath
    )
    b = _diag._diagonal_update_fast(
        ops, state, jnp.float32(1.2), key, model, hb=hbt, heatbath=heatbath,
    )
    assert "carry" in fake_gpu
    assert np.array_equal(np.asarray(a.bond), np.asarray(b.bond))
    assert np.array_equal(np.asarray(a.inputs), np.asarray(b.inputs))
    assert np.array_equal(np.asarray(a.outputs), np.asarray(b.outputs))


@pytest.mark.parametrize("chunks,heatbath", [(7, False), (3, False),
                                             (7, True)])
def test_chunked_precompute_matches_unchunked(chunks, heatbath, monkeypatch):
    """Forcing a tiny element cap splits the parity precompute into many
    M-chunks threaded by the XOR carry; decisions must stay bit-identical
    to the sequential scan."""
    edges = lattice.frustrated_square(4, 4)
    g = QmcIsingGraph(edges, transverse=1.0, replicas=8, seed=9)
    g.sse, _, _, _ = multi_sweep(g.sse, jnp.float32(1.2), g.model, 10)
    g._maybe_grow()
    ops, state, model = g.sse.ops, g.sse.state, g.model
    hbt = _diag.make_heatbath_tables(model) if heatbath else None
    key = jax.random.key(7)
    a = _diag._diagonal_update_scan(
        ops, state, jnp.float32(1.2), key, model, hb=hbt, heatbath=heatbath
    )
    M = ops.bond.shape[0]
    # cap forcing ``chunks`` M-chunks of [Mc, R=8, W] parity words
    W = -(-model.nvars // 32)
    cap = (M // chunks + 1) * 8 * W
    monkeypatch.setattr(_diag, "_PAR_MAX_WORDS", cap)
    _diag._diagonal_update_fast.clear_cache()
    try:
        b = _diag._diagonal_update_fast(
            ops, state, jnp.float32(1.2), key, model,
            hb=hbt, heatbath=heatbath,
        )
    finally:
        _diag._diagonal_update_fast.clear_cache()
    assert np.array_equal(np.asarray(a.bond), np.asarray(b.bond))
    assert np.array_equal(np.asarray(a.inputs), np.asarray(b.inputs))
    assert np.array_equal(np.asarray(a.outputs), np.asarray(b.outputs))


def test_searchsorted_left_bit_equivalence():
    """tables.searchsorted_left (the heat-bath proposal sampler) is
    ``jnp.searchsorted`` side='left' as int32, for one table and per replica
    — duplicates, exact hits and out-of-range queries included."""
    from isingmontecarlo_tpu.sse import tables as _tables

    rng = np.random.default_rng(11)
    for NB in (65, 200, 2049):
        raw = rng.gamma(1.0, 1.0, NB).astype(np.float32)
        raw[rng.uniform(size=NB) < 0.1] = 0.0  # duplicates in the cumsum
        base = raw.cumsum()
        tbl = jnp.asarray(base.astype(np.float32))
        q = np.concatenate([
            rng.uniform(0, float(base[-1]) * 1.05, (37, 8)).astype(np.float32),
            base[rng.integers(0, NB, (5, 8))].astype(np.float32),
            np.full((1, 8), -1.0, np.float32),
            np.full((1, 8), float(base[-1]) * 2, np.float32),
        ])
        qj = jnp.asarray(q)
        want = np.searchsorted(base.astype(np.float32), q, side="left")
        got = np.asarray(_tables.searchsorted_left(tbl, qj))
        assert got.dtype == np.int32 and np.array_equal(got, want), NB
        R = qj.shape[1]
        shift = rng.uniform(0, 1, (R, 1)).astype(np.float32)
        tblR = base[None, :].astype(np.float32) + shift
        wantR = np.stack(
            [np.searchsorted(tblR[r], q[:, r], side="left") for r in range(R)],
            axis=1,
        )
        gotR = np.asarray(_tables.searchsorted_left(jnp.asarray(tblR), qj))
        assert np.array_equal(gotR, wantR), NB


def test_heatbath_fast_path_unaffected_by_searchsorted_route():
    """At a bond table larger than any select chain (6x6: NB = 108) the
    heat-bath fast path, whose proposals come from searchsorted_left, is
    bit-identical to the sequential scan's per-slot searchsorted."""
    g = QmcIsingGraph(
        lattice.bench_two_d_periodic(6), transverse=0.8, replicas=4, seed=3
    )
    g.sse, _, _, _ = multi_sweep(g.sse, jnp.float32(1.2), g.model, 8)
    g._maybe_grow()
    ops, state, model = g.sse.ops, g.sse.state, g.model
    hbt = _diag.make_heatbath_tables(model)
    key = jax.random.key(5)
    kw = dict(hb=hbt, heatbath=True)
    a = _diag._diagonal_update_fast(
        ops, state, jnp.float32(1.2), key, model, **kw
    )
    b = _diag._diagonal_update_scan(
        ops, state, jnp.float32(1.2), key, model, **kw
    )
    assert np.array_equal(np.asarray(a.bond), np.asarray(b.bond))
    assert np.array_equal(np.asarray(a.inputs), np.asarray(b.inputs))
    assert np.array_equal(np.asarray(a.outputs), np.asarray(b.outputs))
