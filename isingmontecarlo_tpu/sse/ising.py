"""TFIM model API — mirror of ``QmcIsingGraph``
(``src/sse/qmc_ising.rs:28-046, 644-795``), batched over replicas.

``H = sum_ij J_ij s^z_i s^z_j + G sum_i s^x_i + h sum_i s^z_i``

The timestep composition mirrors ``qmc_ising.rs:644-795``:

1. diagonal sweep (Metropolis, or heat-bath when enabled);
2. cluster update (weighted when ``h != 0``);
3. resample spins with no ops;
4. grow the cutoff ``M = max(M, n + n/2)`` (host-side re-pad here).

The functional core (:func:`sweep`, :func:`multi_sweep`) is pure and
jit-compiled; :class:`QmcIsingGraph` is the stateful convenience wrapper
mirroring the reference's entry points (``new_with_rng``, ``timesteps``,
``timesteps_sample``, ``timesteps_measure`` — ``qmc_stepper.rs:17-162``).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from isingmontecarlo_tpu.lattice import Edge, nvars_from_edges
from isingmontecarlo_tpu.sse import cluster as _cluster
from isingmontecarlo_tpu.sse import diagonal as _diag
from isingmontecarlo_tpu.sse import opstring as _ops
from isingmontecarlo_tpu.sse.model import BondModel, tfim_model


class SseState(NamedTuple):
    """The whole simulation state as a pytree (checkpointable as-is)."""

    ops: _ops.OpString
    state: jax.Array  # bool[R, N]
    key: jax.Array


class HamInfo(NamedTuple):
    """Data required to evaluate the Hamiltonian (``qmc_ising.rs:890-905``).

    Equality follows the reference's ``PartialEq``: edges and transverse
    field only (``qmc_ising.rs:898-902``)."""

    edges: tuple
    transverse: float
    longitudinal: float
    nvars: int

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, HamInfo)
            and self.edges == other.edges
            and self.transverse == other.transverse
        )

    def __ne__(self, other) -> bool:
        return not self.__eq__(other)


def resample_free_spins(
    sse: SseState, key: jax.Array, model: BondModel,
    has_op: jax.Array | None = None,
) -> SseState:
    """Spins with no ops are resampled uniformly (``qmc_ising.rs:780-784``).

    ``has_op: bool[R, N]`` can be passed by callers that already know the
    per-variable occupation (the sweep driver reads it off the cluster
    update's segment graph for free); otherwise it is derived here with a
    per-lane scatter over all legs."""
    R = sse.state.shape[0]
    if has_op is None:
        vars_ = _ops.op_vars(sse.ops, model)  # [K, M, R]
        K, M, _ = vars_.shape
        has_op = jnp.zeros((R, model.nvars), bool)
        cols = jnp.broadcast_to(
            jnp.arange(R, dtype=jnp.int32)[None, None, :], vars_.shape
        )
        idx = jnp.where(vars_ >= 0, vars_, model.nvars)
        has_op = has_op.at[cols.reshape(-1), idx.reshape(-1)].set(
            True, mode="drop"
        )
    fresh = jax.random.bernoulli(key, 0.5, sse.state.shape)
    return sse._replace(state=jnp.where(has_op, sse.state, fresh))


@functools.partial(
    jax.jit,
    static_argnames=(
        "heatbath", "n_rvb", "cluster_caps", "do_cluster", "rvb_compact"
    ),
)
def sweep(
    sse: SseState,
    beta: jax.Array,
    model: BondModel,
    hb: _diag.HeatBathTables | None = None,
    heatbath: bool = False,
    rvb_tables=None,
    n_rvb: int = 0,
    bond_scale: jax.Array | None = None,
    cluster_caps: tuple[int, int] | None = None,
    do_cluster: bool = True,
    rvb_compact: int | None = None,
    bond_xor: jax.Array | None = None,
) -> tuple[SseState, jax.Array]:
    """One full QMC timestep (``qmc_ising.rs:644-795`` minus cutoff growth).

    ``do_cluster=False`` skips the cluster update and free-spin resample
    (used by ``multi_sweep``'s ``cluster_every`` thinning — any fixed
    schedule of detailed-balance-preserving updates samples the same
    distribution; the reference composition is ``do_cluster=True`` every
    step). Returns ``(state, rvb_successes i32[R])`` (zeros when RVB is
    off).

    ``bond_xor: i32[R, NB]`` carries per-replica sign patterns as weight
    -table substate permutations (see ``diagonal._xor_si``) — the signed
    tempering-ladder path. RVB is excluded with it: its tables bake the
    base model's sign structure."""
    assert bond_xor is None or n_rvb == 0, (
        "RVB updates do not support per-replica sign patterns (bond_xor)"
    )
    return _sweep_impl(
        sse, beta, model, hb, heatbath, rvb_tables, n_rvb, bond_scale,
        cluster_caps, do_cluster, rvb_compact, bond_xor,
    )


def _sweep_impl(
    sse, beta, model, hb, heatbath, rvb_tables, n_rvb, bond_scale,
    cluster_caps, do_cluster, rvb_compact, bond_xor,
):
    """Sweep body. ``do_cluster`` may be a Python bool (static branch, the
    public :func:`sweep` surface) or a traced scalar bool — then a NARROW
    ``lax.cond`` wraps only the cluster+resample stage, so a thinned
    ``multi_sweep`` scan compiles ONE sweep body plus one cluster copy
    (the whole-sweep cond compiled two bodies and the nested-scan form two
    diagonal bodies, doubling compile time). The RNG chain
    splits before the branch, so any fixed flag schedule is bit-identical
    across the three forms (tests/test_thinning.py)."""
    key, k_diag, k_rvb, k_clust, k_free = jax.random.split(sse.key, 5)
    ops = _diag.diagonal_update(
        sse.ops, sse.state, beta, k_diag, model, hb=hb, heatbath=heatbath,
        bond_scale=bond_scale, bond_xor=bond_xor,
    )
    state = sse.state
    if n_rvb > 0:
        from isingmontecarlo_tpu.sse import rvb as _rvb

        ops, state, succ = _rvb.rvb_sweep(
            ops, state, k_rvb, model, rvb_tables, n_rvb,
            compact_cutoff=rvb_compact,
        )
    else:
        succ = jnp.zeros((state.shape[0],), jnp.int32)
    static_flag = isinstance(do_cluster, bool)
    if static_flag and not do_cluster:
        return SseState(ops=ops, state=state, key=key), succ
    if cluster_caps is not None:
        lc, ec = cluster_caps
    else:
        # Cap-less (cold-start / growth) sweeps label at FULL size with no
        # compact/full cond: S as the label cap takes _compact_dispatch's
        # single-pipeline early return. Correctness is unchanged (full-size
        # labels, never skipped); the compiled sweep body halves, and so
        # does its compile time. Costs ~2x on the cluster update only while
        # caps are unknown — a few dispatches.
        lc = ops.bond.shape[0] + model.nvars + 1
        ec = None

    def cluster_stage(ops, state):
        # One segment-graph build serves the cluster update AND the
        # free-spin resampling (a var has ops iff its worldline has a head
        # leg; cluster flips never move ops, so the map stays valid for the
        # new string).
        sg = _cluster.segment_graph(ops, model)
        has_op = (sg.head_f < ops.max_legs * ops.bond.shape[0]).T  # [R, N]
        ops2, state2 = _cluster._cluster_update_impl(
            ops, state, k_clust, model, 0.5, lc, ec, sg, bond_xor=bond_xor
        )
        out = resample_free_spins(
            SseState(ops=ops2, state=state2, key=key), k_free, model,
            has_op=has_op,
        )
        return out.ops, out.state

    if static_flag:
        ops, state = cluster_stage(ops, state)
    else:
        ops, state = jax.lax.cond(
            do_cluster, cluster_stage, lambda o, s: (o, s), ops, state
        )
    return SseState(ops=ops, state=state, key=key), succ


@functools.partial(
    jax.jit,
    static_argnames=(
        "nsweeps", "heatbath", "collect_states", "n_rvb", "cluster_caps",
        "cluster_every", "rvb_compact",
    ),
)
def multi_sweep(
    sse: SseState,
    beta: jax.Array,
    model: BondModel,
    nsweeps: int,
    hb: _diag.HeatBathTables | None = None,
    heatbath: bool = False,
    collect_states: bool = False,
    rvb_tables=None,
    n_rvb: int = 0,
    bond_scale: jax.Array | None = None,
    cluster_caps: tuple[int, int] | None = None,
    cluster_every: int = 1,
    rvb_compact: int | None = None,
    bond_xor: jax.Array | None = None,
    cluster_flags: jax.Array | None = None,
):
    """Run ``nsweeps`` timesteps under one jit; returns per-sweep op counts
    ``i32[T, R]`` (for the energy estimator), optionally sampled states
    ``bool[T, R, N]``, and accumulated RVB successes ``i32[R]``.

    ``cluster_every=k`` runs the (expensive) cluster update + free-spin
    resample on every k-th timestep only — a throughput/autocorrelation
    trade measurable with ``scripts/ess32.py``; ``k=1`` is the reference
    composition. ``cluster_flags`` (``bool[nsweeps]``, TRACED) overrides
    the static schedule: one compiled program then serves EVERY thinning
    factor, so a k-ladder measurement runs k∈{1..6} against a single
    compiled program (scripts/ess32.py). Same fixed-schedule detailed-balance
    argument; bit-identical to the static form for matching schedules
    (tests/test_thinning.py)."""
    kw = dict(
        hb=hb, heatbath=heatbath, rvb_tables=rvb_tables, n_rvb=n_rvb,
        bond_scale=bond_scale, cluster_caps=cluster_caps,
        rvb_compact=rvb_compact, bond_xor=bond_xor,
    )
    static_all = cluster_every == 1 and cluster_flags is None

    def body(carry, do_cluster):
        sse, succ = carry
        # k=1 pins the flag statically (no cond); thinned schedules pass
        # the traced per-sweep flag through — _sweep_impl wraps a NARROW
        # lax.cond around just the cluster+resample stage, so the compiled
        # program is one sweep body + one cluster copy for any nsweeps/k
        # combination (whole-sweep cond and nested-scan forms both compiled
        # a second sweep body, doubling compile time). Fixed schedule →
        # bit-identical results (tests/test_thinning.py).
        new, s = _sweep_impl(
            sse, beta, model, do_cluster=True if static_all
            else do_cluster, **kw,
        )
        out = (_ops.op_count(new.ops), new.state if collect_states else None)
        return (new, succ + s), out

    succ0 = jnp.zeros((sse.state.shape[0],), jnp.int32)
    if cluster_flags is not None:
        flags = cluster_flags
    else:
        flags = (
            jnp.arange(nsweeps, dtype=jnp.int32) % cluster_every
            == cluster_every - 1
        )
    (sse, succ), (ns, states) = jax.lax.scan(
        body, (sse, succ0), flags, length=nsweeps
    )
    return sse, ns, states, succ


@jax.jit
def _cap_counts(ops: _ops.OpString, model: BondModel):
    """Per-batch maxima of (constant-op count, multi-leg-op count) — the
    real label/edge row counts of the cluster label problem (plus N)."""
    b = jnp.maximum(ops.bond, 0)
    occ = ops.bond >= 0
    n_const = jnp.sum(model.is_constant[b] & occ, axis=0)
    arity = jnp.sum(model.bond_vars[b] >= 0, axis=-1)
    n_multi = jnp.sum(occ & (arity >= 2), axis=0)
    return jnp.max(n_const), jnp.max(n_multi)


def new_qmc(edges, transverse, longitudinal=0.0, cutoff=None, *, replicas=1,
            seed=0, state=None):
    """Free-function constructor (``new_qmc``, ``qmc_ising.rs:49-65``)."""
    return QmcIsingGraph(
        edges, transverse, longitudinal, cutoff,
        replicas=replicas, seed=seed, state=state,
    )


def new_qmc_from_graph(graph_state, transverse, longitudinal=0.0, *, seed=0):
    """Seed a QMC run from classical-MC states
    (``new_qmc_from_graph``, ``qmc_ising.rs:68-77``)."""
    return QmcIsingGraph.new_from_graph_state(
        graph_state, transverse, longitudinal, seed=seed
    )


class QmcIsingGraph:
    """Batched transverse-field Ising model QMC.

    Mirrors ``DefaultQmcIsingGraph`` construction and stepping
    (``qmc_ising.rs:49-166``); runs ``R`` independent replicas.
    """

    def __init__(
        self,
        edges: Sequence[tuple[Edge, float]],
        transverse: float,
        longitudinal: float = 0.0,
        cutoff: int | None = None,
        *,
        replicas: int = 1,
        seed: int = 0,
        state: np.ndarray | None = None,
    ):
        self.edges = list(edges)
        self.transverse = float(transverse)
        self.longitudinal = float(longitudinal)
        self.nvars = nvars_from_edges(edges)
        self.model = tfim_model(edges, transverse, longitudinal)
        self.replicas = replicas
        self._heatbath = False
        self._hb_tables: _diag.HeatBathTables | None = None
        self._run_rvb = False
        self._rvb_tables = None
        self._rvb_updates: int | None = None
        # Host-tracked active-slot compaction cutoff for RVB sweeps (None =
        # sweep in full [M] space); refreshed with hysteresis in _maybe_grow.
        self._rvb_compact: int | None = None
        self.total_rvb_successes = 0
        self.rvb_clusters_counted = 0
        # Cold start: the cutoff has not yet tracked n + n/2 — stepping
        # drivers begin in the per-step growth phase (see timesteps_measure).
        self._growth_pending = True
        # No-growth streak persisted ACROSS driver calls: external drivers
        # that step one timestep at a time (e.g. the tempering container's
        # growth loop) could otherwise never observe two consecutive stable
        # steps within one call, leaving _growth_pending True forever.
        self._growth_stable = 0
        # Host-tracked static caps for the cluster label stage (monotone,
        # 16-quantized; see _maybe_grow). None until first measured.
        self._cluster_caps: tuple[int, int] | None = None
        # Cluster update cadence inside fused chunks (1 = every timestep,
        # the reference composition; see set_cluster_every).
        self._cluster_every = 1
        key = jax.random.key(seed)
        key, k_state = jax.random.split(key)
        if state is None:
            spins = jax.random.bernoulli(k_state, 0.5, (replicas, self.nvars))
        else:
            spins = jnp.asarray(state, bool)
            if spins.ndim == 1:
                spins = jnp.broadcast_to(spins[None], (replicas, self.nvars))
        cutoff = max(cutoff or 0, self.nvars, 8)
        self.sse = SseState(
            ops=_ops.empty_opstring(cutoff, replicas, self.model.max_legs),
            state=spins,
            key=key,
        )

    # -- constructors ------------------------------------------------------

    @classmethod
    def new_with_rng(
        cls, edges, transverse, longitudinal=0.0, cutoff=None, *, replicas=1, seed=0,
        state=None,
    ):
        """Mirror of ``QmcIsingGraph::new_with_rng`` (``qmc_ising.rs:118-148``)."""
        return cls(
            edges, transverse, longitudinal, cutoff,
            replicas=replicas, seed=seed, state=state,
        )

    @classmethod
    def new_from_graph_state(cls, graph_state, transverse, longitudinal=0.0, *, seed=0):
        """Mirror of ``new_from_graph`` (``qmc_ising.rs:151-166``): seed the
        quantum simulation from classical-MC states."""
        spins = graph_state.state_ref()
        return cls(
            graph_state.edges, transverse, longitudinal,
            replicas=spins.shape[0], seed=seed, state=np.asarray(spins),
        )

    # -- Hamiltonian access (qmc_ising.rs:169-205) --------------------------

    def make_haminfo(self) -> HamInfo:
        """``qmc_ising.rs:169-176``."""
        return HamInfo(
            edges=tuple((tuple(e), float(j)) for e, j in self.edges),
            transverse=float(self.transverse),
            longitudinal=float(self.longitudinal),
            nvars=self.nvars,
        )

    def hamiltonian(self, bond: int, inputs, outputs) -> float:
        """Matrix element of ``bond`` for the given leg substates
        (``qmc_ising.rs:179-205``), evaluated from the compiled tables."""
        si = sum((1 << l) for l, v in enumerate(inputs) if v)
        so = sum((1 << l) for l, v in enumerate(outputs) if v)
        if self.model.full_w is not None:
            return float(self.model.full_w[bond, si, so])
        return float(self.model.diag_w[bond, si]) if si == so else 0.0

    # -- manager/state swap (qmc_ising.rs:563-602) --------------------------

    def can_swap_managers(self, other: "QmcIsingGraph") -> bool:
        """Graphs can swap when shapes agree (``qmc_ising.rs:563-591``; the
        Hamiltonians may differ — tempering accounts for the weight ratio)."""
        return (
            self.nvars == other.nvars
            and self.replicas == other.replicas
            and self.model.nbonds == other.model.nbonds
        )

    def swap_manager_and_state(self, other: "QmcIsingGraph") -> None:
        """Exchange op strings + states with another graph
        (``qmc_ising.rs:593-602``) — the reference's tempering swap. The
        batched tempering container swaps parameter *labels* instead; this
        direct form exists for API parity and ad-hoc ensembles."""
        assert self.can_swap_managers(other)
        self.sse, other.sse = other.sse, self.sse

    # -- conversion (IntoQmc, qmc_ising.rs:934-976) -------------------------

    def into_qmc(self):
        """Convert into a generic :class:`~isingmontecarlo_tpu.sse.runner.Qmc`
        carrying the same interactions, op string, state, and RNG
        (``qmc_ising.rs:946-976``): edges become diagonal interactions
        ``[-J, J, J, -J]`` with offset, the transverse field a constant 2x2
        interaction, the longitudinal field a diagonal ``[h, -h]`` with
        offset."""
        from isingmontecarlo_tpu.sse.runner import Qmc

        q = Qmc(
            self.nvars,
            replicas=self.replicas,
            do_loop_updates=False,
            state=np.asarray(self.sse.state),
        )
        for (a, b), j in self.edges:
            q.make_diagonal_interaction_and_offset([-j, j, j, -j], [a, b])
        g = self.transverse
        for v in range(self.nvars):
            q.make_interaction([[g, g], [g, g]], [v])
        # The all-Γ constant matrix represents Γ(σˣ + 1): it must stay
        # constant (cluster edges), so the +Γ per site enters the energy
        # offset here. (The reference's IntoQmc drops this shift —
        # qmc_ising.rs:958-963 uses make_interaction — and its conversion
        # test only compares states, qmc_runner energies come out shifted
        # by −nΓ; we keep the physical energy.)
        q.offset += self.nvars * g
        q._model = None
        if abs(self.longitudinal) > 1e-12:
            # Weights must reproduce longitudinal_hamiltonian
            # (qmc_ising.rs:880-888): up -> |h|+h, down -> |h|-h. (The
            # reference's own IntoQmc passes an inverted, sign-indefinite
            # matrix here, qmc_ising.rs:964-967; we match the TFIM physics.)
            h = self.longitudinal
            for v in range(self.nvars):
                q.make_diagonal_interaction_and_offset([-h, h], [v])
        # Bond layout matches tfim_model exactly, so the op string transfers
        # verbatim (same indices, same weights).
        q._sse = self.sse
        return q

    # -- toggles (qmc_ising.rs:435-486) ------------------------------------

    def set_run_rvb(self, run: bool, updates_per_timestep: int | None = None) -> None:
        """Enable RVB sweeps inside every timestep (``qmc_ising.rs:435-441``).

        The reference runs ``(nvars+1)/2`` updates per timestep
        (``qmc_ising.rs:709-710``, 'average cluster size is always 2');
        override with ``updates_per_timestep``."""
        self._run_rvb = run
        if updates_per_timestep is not None:
            self._rvb_updates = updates_per_timestep
        elif not hasattr(self, "_rvb_updates") or self._rvb_updates is None:
            self._rvb_updates = (self.nvars + 1) // 2
        if run and self._rvb_tables is None:
            from isingmontecarlo_tpu.sse import rvb as _rvb

            self._rvb_tables = _rvb.make_rvb_tables(self.edges, self.model)

    def set_enable_heatbath(self, enable: bool) -> None:
        self._heatbath = enable
        if enable and self._hb_tables is None:
            self._hb_tables = _diag.make_heatbath_tables(self.model)

    def set_cluster_every(self, k: int) -> None:
        """Throughput knob (not in the reference): run the cluster
        update + free-spin resample on every ``k``-th timestep inside fused
        chunks instead of every timestep. Any fixed schedule of detailed-
        balance updates samples the same distribution; larger ``k`` trades
        autocorrelation time for per-sweep cost (measure with
        ``scripts/ess32.py``). ``k=1`` restores the reference composition
        (``qmc_ising.rs:644-795``)."""
        assert k >= 1
        self._cluster_every = int(k)

    # -- accessors ---------------------------------------------------------

    @property
    def cutoff(self) -> int:
        return self.sse.ops.cutoff

    def get_cutoff(self) -> int:
        """``qmc_ising.rs:532``."""
        return self.cutoff

    def set_cutoff(self, cutoff: int) -> None:
        """Grow the op-string capacity (``qmc_ising.rs:537``; shrinking is a
        no-op since slots above the old cutoff are identities)."""
        self.sse = self.sse._replace(ops=_ops.grow(self.sse.ops, cutoff))

    def get_nvars(self) -> int:
        return self.nvars

    def get_edges(self):
        return self.edges

    def get_transverse_field(self) -> float:
        return self.transverse

    def get_longitudinal_field(self) -> float:
        return self.longitudinal

    def set_state(self, state) -> None:
        """Overwrite the p=0 state (``state_mut``, ``qmc_ising.rs:497``)."""
        spins = jnp.asarray(state, bool)
        if spins.ndim == 1:
            spins = jnp.broadcast_to(spins[None], (self.replicas, self.nvars))
        self.sse = self.sse._replace(state=spins)

    def state_mut(self):
        """Context manager yielding a mutable host copy of the p=0 state,
        committed on exit (``state_mut``, ``qmc_ising.rs:497``; mutation is
        explicit here because device arrays are immutable)::

            with g.state_mut() as s:
                s[:, 0] = True
        """
        import contextlib

        @contextlib.contextmanager
        def _ctx():
            s = np.asarray(self.sse.state).copy()
            yield s
            self.set_state(s)

        return _ctx()

    def get_n(self) -> jax.Array:
        """Op count per replica ``i32[R]``."""
        return _ops.op_count(self.sse.ops)

    def get_bond_count(self, bond: int) -> jax.Array:
        """Ops at a given bond per replica (``qmc_stepper.rs:14``)."""
        return _ops.bond_counts(self.sse.ops, self.model.nbonds)[:, bond]

    def state_ref(self) -> jax.Array:
        return self.sse.state

    def clone_state(self) -> np.ndarray:
        return np.asarray(self.sse.state)

    def into_vec(self) -> np.ndarray:
        """Consume into the p=0 state array (``qmc_ising.rs:507-510``)."""
        return np.asarray(self.sse.state).copy()

    def get_manager_ref(self) -> _ops.OpString:
        """The op-string container — the reference's op manager
        (``qmc_ising.rs:548-550``)."""
        return self.sse.ops

    def get_manager_mut(self) -> _ops.OpString:
        """``qmc_ising.rs:553-555``; op strings are immutable pytrees here —
        mutate by building a new one and assigning ``graph.sse =
        graph.sse._replace(ops=...)``."""
        return self.sse.ops

    def get_offset(self) -> float:
        return self.model.offset

    def get_energy_for_average_n(self, average_n, beta) -> jax.Array:
        """``E = -<n>/beta + offset`` (``qmc_ising.rs:805-809``)."""
        return -(jnp.asarray(average_n, jnp.float32) / beta) + self.model.offset

    def verify(self) -> bool:
        """Worldline integrity of every replica (``qmc_ising.rs:824-861``)."""
        return bool(jnp.all(_ops.verify(self.sse.ops, self.sse.state, self.model)))

    def imaginary_time_states(self) -> jax.Array:
        """All propagated states ``bool[M, R, N]`` (``itime_fold``).

        Materializes O(M·R·N); for deep strings use
        :meth:`imaginary_time_fold`."""
        return _ops.itime_states(self.sse.ops, self.sse.state, self.model)

    def imaginary_time_fold(self, fold_fn, init):
        """Streaming fold over all ``M`` propagated imaginary-time states
        (``imaginary_time_fold``, ``qmc_stepper.rs:165-167``) without
        materializing the trajectory; ``fold_fn(acc, state_at_p)`` must be
        jax-traceable (runs inside ``lax.scan``)."""
        return _ops.itime_fold(
            self.sse.ops, self.sse.state, self.model, fold_fn, init
        )

    # -- debug / introspection (qmc_debug.rs, qmc_ising.rs:489-494) --------

    def count_diagonal_and_off(self):
        """Per-replica (diagonal, off-diagonal) counts (``qmc_debug.rs:10``)."""
        from isingmontecarlo_tpu.sse import debug as _debug

        return _debug.count_diagonal_and_off(self.sse.ops)

    def count_constant_ops(self):
        """Per-replica constant-op counts (``qmc_debug.rs:28``)."""
        from isingmontecarlo_tpu.sse import debug as _debug

        return _debug.count_constant_ops(self.sse.ops, self.model)

    def print_debug(self, replica: int = 0) -> None:
        """ASCII worldline dump of one replica (``qmc_ising.rs:489-494``,
        ``diagonal.rs:194-234``)."""
        import sys

        from isingmontecarlo_tpu.sse import debug as _debug

        _debug.debug_print_diagonal(
            self.sse.ops, self.sse.state, self.model, replica, file=sys.stdout
        )

    # -- checkpointing (the reference `serialize` feature) ------------------

    def save(self, path: str, *, strip_rng: bool = False) -> None:
        from isingmontecarlo_tpu import checkpoint as _ckpt

        _ckpt.save_qmc_ising(path, self, strip_rng=strip_rng)

    @classmethod
    def load(cls, path: str, *, seed: int | None = None) -> "QmcIsingGraph":
        from isingmontecarlo_tpu import checkpoint as _ckpt

        return _ckpt.load_qmc_ising(path, seed=seed)

    # -- autocorrelations (QmcAutoCorrelations, autocorrelations.rs:6-97) ---

    def calculate_autocorrelation(
        self,
        timesteps: int,
        beta: float,
        sampling_freq: int | None,
        sample_mapper: Callable[[jax.Array], jax.Array],
    ) -> np.ndarray:
        """Run ``timesteps``, map each sampled state through ``sample_mapper``
        (acting on ``bool[T, R, N]``), FFT-autocorrelate along time
        (``autocorrelations.rs:8-35``). Returns ``f32[num_samples]``."""
        from isingmontecarlo_tpu.analysis import autocorr as _ac

        states, _ = self.timesteps_sample(timesteps, beta, sampling_freq)
        return np.asarray(_ac.sample_autocorrelation(jnp.asarray(states), sample_mapper))

    def calculate_variable_autocorrelation(
        self, timesteps: int, beta: float, sampling_freq: int | None = None
    ) -> np.ndarray:
        """Autocorrelation of spin variables (``autocorrelations.rs:38-50``)."""
        from isingmontecarlo_tpu.analysis import autocorr as _ac

        states, _ = self.timesteps_sample(timesteps, beta, sampling_freq)
        return np.asarray(_ac.spin_autocorrelation(jnp.asarray(states)))

    def calculate_spin_product_autocorrelation(
        self,
        timesteps: int,
        beta: float,
        var_products: Sequence[Sequence[int]],
        sampling_freq: int | None = None,
    ) -> np.ndarray:
        """Autocorrelation of spin products (``autocorrelations.rs:53-70``)."""
        from isingmontecarlo_tpu.analysis import autocorr as _ac

        states, _ = self.timesteps_sample(timesteps, beta, sampling_freq)
        return np.asarray(
            _ac.product_autocorrelation(jnp.asarray(states), var_products)
        )

    def calculate_bond_autocorrelation(
        self, timesteps: int, beta: float, sampling_freq: int | None = None
    ) -> np.ndarray:
        """Autocorrelation of bond satisfaction (``qmc_ising.rs:978-998``)."""
        from isingmontecarlo_tpu.analysis import autocorr as _ac
        from isingmontecarlo_tpu.lattice import edge_arrays

        states, _ = self.timesteps_sample(timesteps, beta, sampling_freq)
        ev, ej = edge_arrays(self.edges)
        return np.asarray(_ac.bond_autocorrelation(jnp.asarray(states), ev, ej))

    # -- stepping ----------------------------------------------------------

    def single_diagonal_step(self, beta: float) -> None:
        """One diagonal sweep only (``qmc_ising.rs:208-273``)."""
        key, k_diag = jax.random.split(self.sse.key)
        ops = _diag.diagonal_update(
            self.sse.ops,
            self.sse.state,
            jnp.float32(beta),
            k_diag,
            self.model,
            hb=self._hb_tables if self._heatbath else None,
            heatbath=self._heatbath,
        )
        self.sse = self.sse._replace(ops=ops, key=key)
        self._maybe_grow()

    def single_cluster_step(self) -> None:
        """One cluster update only (``qmc_ising.rs:275-321``)."""
        key, k_clust = jax.random.split(self.sse.key)
        lc, ec = self._cluster_caps or (None, None)
        ops, state = _cluster.cluster_update(
            self.sse.ops, self.sse.state, k_clust, self.model,
            label_cap=lc, edge_cap=ec,
        )
        self.sse = SseState(ops=ops, state=state, key=key)

    def single_rvb_sweep(
        self, updates_in_sweep: int | None = None
    ) -> tuple[int, int]:
        """RVB updates only (``qmc_ising.rs:323-418``). Returns
        ``(successes summed over replicas, clusters counted)``."""
        from isingmontecarlo_tpu.sse import rvb as _rvb

        if self._rvb_tables is None:
            self._rvb_tables = _rvb.make_rvb_tables(self.edges, self.model)
        n = updates_in_sweep or (self.nvars + 1) // 2
        key, k_rvb = jax.random.split(self.sse.key)
        ops, state, succ = _rvb.rvb_sweep(
            self.sse.ops, self.sse.state, k_rvb, self.model, self._rvb_tables, n
        )
        self.sse = SseState(ops=ops, state=state, key=key)
        succs = int(jnp.sum(succ))
        counted = n * self.replicas
        self.total_rvb_successes += succs
        self.rvb_clusters_counted += counted
        return succs, counted

    def rvb_success_rate(self) -> float:
        """``qmc_ising.rs:605-607``."""
        return self.total_rvb_successes / max(self.rvb_clusters_counted, 1)

    def _maybe_grow(self) -> None:
        """Cutoff growth ``M = max(M, n + n/2)`` (``qmc_ising.rs:786``),
        quantized to multiples of 16 to bound recompiles. Also refreshes the
        host-tracked cluster label caps (static compaction sizes; the
        in-jit ``fits`` cond keeps correctness if a chunk outgrows them
        before the next refresh)."""
        n_max = int(jnp.max(_ops.op_count(self.sse.ops)))
        want = n_max + n_max // 2
        if want > self.cutoff:
            new_m = ((max(want, self.cutoff) + 15) // 16) * 16
            self.sse = self.sse._replace(ops=_ops.grow(self.sse.ops, new_m))
        if self._run_rvb:
            # Active-slot compaction cutoff for RVB sweeps: covers the
            # current max per-replica op count with 25% slack (the diagonal
            # update can grow counts within a fused chunk before the next
            # host refresh; lanes that still overflow skip RVB for that
            # sweep — see rvb.rvb_sweep). Hysteresis: grow on demand,
            # shrink only past 2x, to bound recompiles; disabled when it
            # would not cut at least ~1/8 of the slot axis.
            want_c = 16 * ((n_max + (n_max >> 2) + 2 + 15) // 16)
            cur = self._rvb_compact
            if cur is None or want_c > cur or want_c * 2 < cur:
                cur = want_c
            self._rvb_compact = (
                cur if cur <= self.cutoff - (self.cutoff >> 3) else None
            )
        nc, nm = _cap_counts(self.sse.ops, self.model)
        N = self.nvars
        want_l = max(256, 16 * ((int((int(nc) + N + 2) * 1.3) + 15) // 16))
        want_e = max(256, 16 * ((int((int(nm) + N + 2) * 1.3) + 15) // 16))
        cur = self._cluster_caps or (0, 0)
        if want_l > cur[0] or want_e > cur[1]:
            self._cluster_caps = (max(want_l, cur[0]), max(want_e, cur[1]))

    def _rvb_args(self) -> dict:
        """Per-sweep keyword args derived from graph state (RVB config and
        the static cluster label caps)."""
        return dict(
            rvb_tables=self._rvb_tables if self._run_rvb else None,
            n_rvb=(self._rvb_updates or 0) if self._run_rvb else 0,
            cluster_caps=self._cluster_caps,
            rvb_compact=self._rvb_compact if self._run_rvb else None,
        )

    def _count_rvb(self, succ, nsweeps: int) -> None:
        if self._run_rvb:
            self.total_rvb_successes += int(jnp.sum(succ))
            self.rvb_clusters_counted += (
                (self._rvb_updates or 0) * self.replicas * nsweeps
            )

    def timestep(self, beta: float) -> jax.Array:
        """One QMC timestep; returns the state (``qmc_ising.rs:644-795``)."""
        self.sse, succ = sweep(
            self.sse,
            jnp.float32(beta),
            self.model,
            hb=self._hb_tables if self._heatbath else None,
            heatbath=self._heatbath,
            **self._rvb_args(),
        )
        self._count_rvb(succ, 1)
        self._maybe_grow()
        return self.sse.state

    def timesteps(self, t: int, beta: float, chunk: int = 16) -> jax.Array:
        """``t`` timesteps; returns average energy per replica ``f32[R]``
        (``qmc_stepper.rs:17-20``)."""
        _, energy = self.timesteps_measure(t, beta, None, lambda acc, s: acc, chunk=chunk)
        return energy

    def timesteps_sample(
        self, t: int, beta: float, sampling_freq: int | None = None, chunk: int = 16
    ):
        """Returns ``(states bool[num_samples, R, N], energy f32[R])``
        (``qmc_stepper.rs:23-40``)."""
        samples: list[np.ndarray] = []
        acc, energy = self.timesteps_measure(
            t,
            beta,
            samples,
            lambda acc, s: (acc.append(np.asarray(s)), acc)[1],
            sampling_freq,
            chunk=chunk,
        )
        return np.stack(acc) if acc else np.zeros((0, self.replicas, self.nvars), bool), energy

    def timesteps_sample_iter(
        self,
        t: int,
        beta: float,
        sampling_freq: int | None,
        iter_fn: Callable[[jax.Array], None],
        chunk: int = 16,
    ) -> jax.Array:
        """Call ``iter_fn(state)`` on every sample (``qmc_stepper.rs:43-73``);
        returns the average energy per replica."""
        _, energy = self.timesteps_measure(
            t, beta, None,
            lambda acc, s: (iter_fn(s), acc)[1],
            sampling_freq, chunk=chunk,
        )
        return energy

    def timesteps_sample_iter_zip(
        self,
        t: int,
        beta: float,
        sampling_freq: int | None,
        zip_with,
        iter_fn: Callable[[Any, jax.Array], None],
        chunk: int = 16,
    ) -> jax.Array:
        """Zip samples with an iterable (``qmc_stepper.rs:97-130``):
        ``iter_fn(next(zip_with), state)`` per sample, stopping the
        measurement fold when the iterable is exhausted."""
        it = iter(zip_with)

        def fold(acc, s):
            try:
                z = next(it)
            except StopIteration:
                return acc
            iter_fn(z, s)
            return acc

        _, energy = self.timesteps_measure(
            t, beta, None, fold, sampling_freq, chunk=chunk
        )
        return energy

    def timesteps_measure(
        self,
        timesteps: int,
        beta: float,
        init_acc: Any,
        state_fold: Callable[[Any, jax.Array], Any],
        sampling_freq: int | None = None,
        chunk: int = 16,
    ):
        """Fold over sampled states (``qmc_stepper.rs:133-162``): measures at
        every ``sampling_freq``-th step, accumulates the op count for the
        energy estimator, returns ``(acc, energy f32[R])``."""
        freq = sampling_freq or 1
        beta_arr = jnp.float32(beta)
        acc = init_acc
        total_n = jnp.zeros((self.replicas,), jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
        steps_measured = 0
        done = 0
        stable = 2 if not self._growth_pending else self._growth_stable
        while done < timesteps:
            # Growth phase: the reference grows the cutoff after EVERY
            # timestep (``qmc_ising.rs:786``); fused chunks only check
            # between dispatches, which from a cold (small) cutoff leaves the
            # op string truncated for whole chunks and biases the energy
            # estimator high. Run single timesteps until two consecutive
            # steps stop growing, then switch to fused chunks.
            todo = 1 if stable < 2 else min(chunk, timesteps - done)
            collect = any((done + i + 1) % freq == 0 for i in range(todo))
            self.sse, ns, states, succ = multi_sweep(
                self.sse,
                beta_arr,
                self.model,
                todo,
                hb=self._hb_tables if self._heatbath else None,
                heatbath=self._heatbath,
                collect_states=collect,
                # Growth-phase single steps keep the full composition so
                # off-diagonal mixing starts immediately from a cold string.
                cluster_every=self._cluster_every if todo > 1 else 1,
                **self._rvb_args(),
            )
            self._count_rvb(succ, todo)
            for i in range(todo):
                t_global = done + i
                if (t_global + 1) % freq == 0:
                    if states is not None:
                        acc = state_fold(acc, states[i])
                    total_n = total_n + ns[i]
                    steps_measured += 1
            done += todo
            before = self.cutoff
            self._maybe_grow()
            stable = 0 if self.cutoff != before else stable + 1
        self._growth_stable = stable
        self._growth_pending = stable < 2
        average_n = total_n / max(steps_measured, 1)
        return acc, self.get_energy_for_average_n(average_n, beta)
