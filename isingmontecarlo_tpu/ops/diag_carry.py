"""The SSE diagonal update's op-count carry as a CUDA kernel.

The precomputed-weights diagonal update (``sse/diagonal.py``,
``_diagonal_update_fast``) reduces the Sandvik sweep (``diagonal.rs:141-191``)
to one sequential dependence: the op count ``n``. Each slot's insert/remove
decision is a function of ``n`` and of per-slot values computed up front. As
an XLA ``lax.scan`` over M slots every step is a separate launch of a tiny
``[R]``-wide body. The kernel (``kernels.cu``, ``DiagCarryKernel``) gives each
replica one thread that walks all M slots with ``n`` in a register.

The slot data travels packed: ``kind u8[M, R]`` (0 none, 1 insert candidate,
2 removable diagonal op) and, for Metropolis, one threshold ``f32[M, R]``
(``num_ins`` at insert candidates, ``num_rem`` at diagonal ops); heat-bath
folds its n-independent insert test into ``kind`` and passes ``beta * total``
per replica. :func:`carry_reference` is the same computation as a
``lax.scan`` over the packed inputs — the kernel's plain twin.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from isingmontecarlo_tpu.ops import _cuda


def pack(idp, dgp, p1, p2, *, heatbath: bool):
    """``(kind u8[M, R], thr f32[M, R] | None)`` from the unpacked planes.

    ``p1``/``p2`` are ``num_ins``/``num_rem`` (Metropolis) or
    ``insw``/unused (heat-bath). Insert candidates and diagonal ops are
    disjoint (identity vs occupied slots), so one code per slot suffices."""
    ins_ok = idp & p1 if heatbath else idp
    kind = jnp.where(ins_ok, 1, jnp.where(dgp, 2, 0)).astype(jnp.uint8)
    thr = None if heatbath else jnp.where(idp, p1, p2).astype(jnp.float32)
    return kind, thr


def carry_reference(n0, u0, kind, thr, bwt, *, heatbath: bool):
    """The kernel's plain twin: ``code u8[M, R]`` by a ``lax.scan`` with the
    arithmetic of ``sse.diagonal._ins_rem`` on the packed inputs."""
    M = u0.shape[0]

    def step(n, xs):
        u, k = xs[:2]
        mmn = (M - n).astype(jnp.float32)
        if heatbath:
            ins = (k == 1) & (u * (mmn + bwt) < bwt)
            rem = (k == 2) & (u * (mmn + 1.0 + bwt) < (mmn + 1.0))
        else:
            t = xs[2]
            ins = (k == 1) & (u * mmn < t)
            rem = (k == 2) & (u * t < (mmn + 1.0))
        code = jnp.where(ins, 1, jnp.where(rem, 2, 0)).astype(jnp.uint8)
        return n + ins.astype(jnp.int32) - rem.astype(jnp.int32), code

    xs = (u0, kind) if heatbath else (u0, kind, thr)
    return jax.lax.scan(step, n0.astype(jnp.int32), xs)[1]


def carry_kernel(n0, u0, kind, thr, bwt, *, heatbath: bool):
    """``code u8[M, R]`` from the CUDA kernel (GPU only; see
    :func:`isingmontecarlo_tpu.ops.backend.gpu_kernels`)."""
    _cuda.register()
    name = (
        "ising_diag_carry_heatbath" if heatbath
        else "ising_diag_carry_metropolis"
    )
    last = (
        jnp.broadcast_to(jnp.asarray(bwt, jnp.float32), n0.shape) if heatbath
        else thr
    )
    return jax.ffi.ffi_call(
        name, jax.ShapeDtypeStruct(u0.shape, jnp.uint8),
        vmap_method="sequential",
    )(n0.astype(jnp.int32), u0.astype(jnp.float32), kind, last)


def carry_decisions(n0, u0, idp, dgp, p1, p2, bwt, *, heatbath: bool):
    """Insert/remove decisions ``(bool[M, R], bool[M, R])`` for all slots from
    the kernel, bit-identical to the sequential ``lax.scan`` carry."""
    kind, thr = pack(idp, dgp, p1, p2, heatbath=heatbath)
    code = carry_kernel(n0, u0, kind, thr, bwt, heatbath=heatbath)
    return code == 1, code == 2
