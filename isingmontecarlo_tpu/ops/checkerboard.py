"""Multi-sweep checkerboard Metropolis on a periodic uniform square lattice,
as a CUDA kernel, and its plain-jnp twin.

The XLA version (:func:`isingmontecarlo_tpu.classical.metropolis.checkerboard_sweep`)
round-trips the spin field through device memory every half sweep and draws
threefry uniforms for the whole field, half of them for the masked colour.
The kernel (``kernels.cu``, ``CheckerboardKernel``) holds one replica's field
in shared memory for ``nsweeps`` sweeps (``L * L`` bytes, so ``L <= 480``)
and touches device memory once on load and once on store. Reference
semantics: energy ``E = sum_e J s_i s_j - h sum s``
(``src/classical/graph.rs:430-447``), single-spin flip ``dE = -2 J s nsum +
2 h s`` and acceptance ``dE <= 0 || u < exp(-beta dE)`` (``graph.rs:339-347``),
applied colour by colour.

Randomness is Philox-4x32-10 (Salmon et al., SC'11) with key ``(seed, 0)``
and counter ``(group, sweep, colour, replica)``: colour ``c`` holds the sites
with ``(x + y) % 2 == c``; site ``(y, x)`` has half-lattice index
``i = y * L/2 + x // 2``, group ``i // 4`` and word ``i % 4``; ``u =
(word >> 8) * 2^-24``. Acceptance compares ``u`` with a ten-entry threshold
table indexed by ``spin * 5 + up_neighbours``, computed once per call by
:func:`thresholds`, so no transcendental runs in the kernel and the kernel
and :func:`checkerboard_twin` agree bit for bit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from isingmontecarlo_tpu.ops import _cuda

_PHILOX_M0 = np.uint32(0xD2511F53)
_PHILOX_M1 = np.uint32(0xCD9E8D57)
_PHILOX_W0 = np.uint32(0x9E3779B9)
_PHILOX_W1 = np.uint32(0xBB67AE85)

# Shared memory a block may hold (Hopper), minus the threshold table.
_SMEM_BYTES = 232448 - 64


def kernel_supports(L: int) -> bool:
    """Lattices the kernel takes: four-aligned (groups of four sites share
    a half row) and small enough for one block's shared memory."""
    return L % 4 == 0 and L * L <= _SMEM_BYTES


def _mulhilo(a, b):
    """``(hi, lo)`` 32-bit halves of the 64-bit product of uint32 arrays,
    from 16-bit limbs (no 64-bit types needed)."""
    lo = a * b
    al, ah = a & 0xFFFF, a >> 16
    bl, bh = b & 0xFFFF, b >> 16
    t = al * bl
    m1 = ah * bl
    m2 = al * bh
    mid = (t >> 16) + (m1 & 0xFFFF) + (m2 & 0xFFFF)
    hi = ah * bh + (m1 >> 16) + (m2 >> 16) + (mid >> 16)
    return hi, lo


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox-4x32-10 on uint32 arrays (broadcasting); returns four words."""
    c = [jnp.asarray(x, jnp.uint32) for x in (c0, c1, c2, c3)]
    k0 = jnp.asarray(k0, jnp.uint32)
    k1 = jnp.asarray(k1, jnp.uint32)
    for _ in range(10):
        hi0, lo0 = _mulhilo(jnp.uint32(_PHILOX_M0), c[0])
        hi1, lo1 = _mulhilo(jnp.uint32(_PHILOX_M1), c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
        k0 = k0 + _PHILOX_W0
        k1 = k1 + _PHILOX_W1
    return c


def thresholds(beta, j, h) -> jax.Array:
    """``f32[10]``: ``exp(-beta * max(dE, 0))`` at ``spin * 5 + up``, with
    ``dE`` as in ``checkerboard_sweep`` (``-2 j nsum s + 2 h s``)."""
    up = jnp.arange(5, dtype=jnp.float32)
    nsum = 2.0 * up - 4.0
    s = jnp.array([-1.0, 1.0], jnp.float32)[:, None]
    de = -2.0 * jnp.float32(j) * nsum * s + 2.0 * jnp.float32(h) * s
    return jnp.exp(-jnp.float32(beta) * jnp.maximum(de, 0.0)).reshape(10)


def _half_uniforms(seed, R, L, sweep, colour):
    """``f32[R, L, L/2]`` uniforms of one colour's half lattice."""
    H = L // 2
    G = L * H // 4
    g = jnp.arange(G, dtype=jnp.uint32)[None, :]
    r = jnp.arange(R, dtype=jnp.uint32)[:, None]
    w = philox4x32(g, sweep, colour, r, seed, 0)
    words = jnp.stack(w, axis=-1).reshape(R, L, H)
    return (words >> 8).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))


@functools.partial(jax.jit, static_argnames=("nsweeps",))
def checkerboard_twin(spins, seed, thr, nsweeps: int):
    """Plain-jnp twin of the kernel: ``bool[R, L, L]`` after ``nsweeps``
    sweeps, bit-identical to :func:`checkerboard_multi_sweep` on the GPU."""
    R, L, _ = spins.shape
    seed = jnp.asarray(seed).astype(jnp.uint32)
    yy = jax.lax.broadcasted_iota(jnp.int32, (L, L), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (L, L), 1)
    colour_of = (xx + yy) % 2

    def sweep(s, sp):
        for c in range(2):
            si = sp.astype(jnp.int32)
            up = (
                jnp.roll(si, 1, axis=-1) + jnp.roll(si, -1, axis=-1)
                + jnp.roll(si, 1, axis=-2) + jnp.roll(si, -1, axis=-2)
            )
            u = jnp.repeat(
                _half_uniforms(seed, R, L, s.astype(jnp.uint32), c), 2, axis=-1
            )
            acc = u < thr[si * 5 + up]
            sp = jnp.where((colour_of == c)[None] & acc, ~sp, sp)
        return sp

    return jax.lax.fori_loop(0, nsweeps, sweep, spins)


@functools.partial(jax.jit, static_argnames=("nsweeps",))
def checkerboard_multi_sweep(spins, seed, thr, nsweeps: int):
    """``nsweeps`` checkerboard Metropolis sweeps of ``bool[R, L, L]`` in the
    CUDA kernel (GPU only; ``kernel_supports(L)`` must hold)."""
    _cuda.register()
    out = jax.ffi.ffi_call(
        "ising_checkerboard",
        jax.ShapeDtypeStruct(spins.shape, jnp.uint8),
        vmap_method="sequential",
    )(
        spins.astype(jnp.uint8), thr.astype(jnp.float32),
        jnp.asarray(seed).astype(jnp.uint32).reshape(1),
        nsweeps=np.int32(nsweeps),
    )
    return out.astype(bool)
