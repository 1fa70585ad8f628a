"""CPU tests of the CUDA kernels' surroundings: the plain-jnp twins the
kernels are checked against on the card, the wrappers' packing and shapes,
the single backend switch, and the compile-cache location. The kernels
themselves run only on a GPU (tests/test_gpu_kernels.py)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from isingmontecarlo_tpu import compile_cache
from isingmontecarlo_tpu.classical import metropolis as _metro
from isingmontecarlo_tpu.classical.lattice_ising import LatticeIsing
from isingmontecarlo_tpu.ops import backend, checkerboard, diag_carry
from isingmontecarlo_tpu.sse import diagonal as _diag

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- Philox and the checkerboard twin ---------------------------------------


@pytest.mark.parametrize(
    "ctr,key,want",
    [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        (
            (0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
            (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD),
        ),
    ],
)
def test_philox_known_answers(ctr, key, want):
    """Random123's published Philox-4x32-10 known-answer vectors."""
    got = checkerboard.philox4x32(*ctr, *key)
    assert [int(x) for x in got] == list(want)


def test_mulhilo_matches_64bit_product():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, 4096, dtype=np.uint64)
    b = rng.integers(0, 2**32, 4096, dtype=np.uint64)
    hi, lo = checkerboard._mulhilo(
        jnp.asarray(a, jnp.uint32), jnp.asarray(b, jnp.uint32)
    )
    p = a * b
    assert np.array_equal(np.asarray(hi), (p >> 32).astype(np.uint32))
    assert np.array_equal(np.asarray(lo), (p & 0xFFFFFFFF).astype(np.uint32))


def test_thresholds_match_xla_acceptance():
    """The ten-entry table is the XLA sweep's ``exp(-beta max(dE, 0))`` at
    every (spin, up-neighbour count)."""
    beta, j, h = 0.37, -1.0, 0.3
    thr = np.asarray(checkerboard.thresholds(beta, j, h))
    for s in (0, 1):
        for up in range(5):
            sig = jnp.float32(2 * s - 1)
            nsum = jnp.float32(2 * up - 4)
            de = -2.0 * jnp.float32(j) * nsum * sig + 2.0 * jnp.float32(h) * sig
            want = jnp.exp(-jnp.float32(beta) * jnp.maximum(de, 0.0))
            assert thr[s * 5 + up] == np.float32(want)


def test_twin_single_half_sweep_by_hand():
    """One colour of one sweep, recomputed site by site in numpy from the
    same Philox words: the twin's site-to-word map and update rule."""
    R, L = 2, 8
    spins = jax.random.bernoulli(jax.random.key(1), 0.5, (R, L, L))
    thr = checkerboard.thresholds(0.5, -1.0, 0.1)
    seed = np.uint32(99)
    # Sweep 0 colour 0, then colour 1; check colour 0 only through a state
    # whose colour-1 sites the twin has not yet touched.
    out = np.asarray(checkerboard.checkerboard_twin(spins, seed, thr, 1))
    s = np.asarray(spins).astype(int)
    u = np.asarray(checkerboard._half_uniforms(seed, R, L, np.uint32(0), 0))
    want = s.copy()
    for r in range(R):
        for y in range(L):
            for x in range(L):
                if (x + y) % 2:
                    continue
                up = (s[r, (y - 1) % L, x] + s[r, (y + 1) % L, x]
                      + s[r, y, (x - 1) % L] + s[r, y, (x + 1) % L])
                if u[r, y, x // 2] < float(thr[s[r, y, x] * 5 + up]):
                    want[r, y, x] ^= 1
    mask = (np.add.outer(np.arange(L), np.arange(L)) % 2) == 0
    assert np.array_equal(out[:, mask], want[:, mask].astype(bool))


def test_twin_deterministic_and_seeded():
    spins = jax.random.bernoulli(jax.random.key(2), 0.5, (3, 12, 12))
    thr = checkerboard.thresholds(0.4, -1.0, 0.0)
    a = checkerboard.checkerboard_twin(spins, np.uint32(5), thr, 4)
    b = checkerboard.checkerboard_twin(spins, np.uint32(5), thr, 4)
    c = checkerboard.checkerboard_twin(spins, np.uint32(6), thr, 4)
    assert np.array_equal(np.asarray(a), np.asarray(b))
    assert not np.array_equal(np.asarray(a), np.asarray(c))


@pytest.mark.parametrize("beta", [0.3, 0.6])
def test_twin_statistics_match_threefry_path(beta):
    """Same Markov chain, different random streams: energy per site after
    equilibration agrees with the XLA threefry path within statistics."""
    L, R, warm, meas = 16, 32, 150, 20
    up = jnp.ones((R, L, L), bool)
    thr = checkerboard.thresholds(beta, -1.0, 0.0)
    sp = checkerboard.checkerboard_twin(up, np.uint32(3), thr, warm)
    sx = _metro.lattice_multi_sweep(up, 3, beta, -1.0, 0.0, warm)
    et, ex = [], []
    for k in range(meas):
        sp = checkerboard.checkerboard_twin(sp, np.uint32(100 + k), thr, 2)
        sx = _metro.lattice_multi_sweep(sx, 100 + k, beta, -1.0, 0.0, 2)
        et.append(np.asarray(_metro.lattice_energy(sp, -1.0, 0.0)) / L**2)
        ex.append(np.asarray(_metro.lattice_energy(sx, -1.0, 0.0)) / L**2)
    et, ex = np.concatenate(et), np.concatenate(ex)
    err = np.hypot(et.std(), ex.std()) / np.sqrt(R * meas / 4)
    assert abs(et.mean() - ex.mean()) < 5 * err + 1e-3, (et.mean(), ex.mean())


@pytest.mark.parametrize(
    "L,ok", [(4, True), (6, False), (256, True), (480, True), (484, False)]
)
def test_checkerboard_kernel_gate(L, ok):
    """Four-aligned lattices whose field fits one block's shared memory."""
    assert checkerboard.kernel_supports(L) is ok


@pytest.mark.parametrize("L,path", [(8, "checkerboard"), (6, "xla")])
def test_lattice_dispatch(fake_gpu, L, path):
    m = LatticeIsing(L, j=-1.0, replicas=2, seed=4)
    m.run_sweeps(3, beta=0.5)
    assert m.spins.shape == (2, L, L) and m.spins.dtype == bool
    assert fake_gpu == (["checkerboard"] if path == "checkerboard" else [])


# --- diagonal-update carry ---------------------------------------------------


@pytest.mark.parametrize("heatbath", [False, True])
def test_carry_reference_matches_ins_rem_scan(heatbath):
    """The packed twin decides every slot as the unpacked ``_ins_rem``
    carry does, Metropolis and heat-bath."""
    rng = np.random.default_rng(int(heatbath))
    M, R = 300, 16
    u0 = jnp.asarray(rng.random((M, R), np.float32))
    occ = rng.random((M, R)) < 0.5
    idp = jnp.asarray(~occ)
    dgp = jnp.asarray(occ & (rng.random((M, R)) < 0.8))
    n0 = jnp.asarray(occ.sum(0).astype(np.int32))
    p1 = jnp.asarray(rng.random((M, R)) < 0.6) if heatbath else jnp.asarray(
        rng.gamma(2.0, 40.0, (M, R)).astype(np.float32))
    p2 = p1 if heatbath else jnp.asarray(
        rng.gamma(2.0, 40.0, (M, R)).astype(np.float32))
    bwt = jnp.asarray(rng.uniform(50, 200, R).astype(np.float32))
    extra = (p1,) if heatbath else (p1, p2)

    def step(n, xs):
        ins, rem = _diag._ins_rem(
            n, *xs, M=M, heatbath=heatbath, bw_tot=bwt if heatbath else 0.0
        )
        return n + ins.astype(jnp.int32) - rem.astype(jnp.int32), (ins, rem)

    _, (ins, rem) = jax.lax.scan(step, n0, (u0, idp, dgp) + extra)
    kind, thr = diag_carry.pack(idp, dgp, p1, p2, heatbath=heatbath)
    code = diag_carry.carry_reference(n0, u0, kind, thr, bwt, heatbath=heatbath)
    assert code.dtype == jnp.uint8 and code.shape == (M, R)
    assert np.array_equal(np.asarray(code == 1), np.asarray(ins))
    assert np.array_equal(np.asarray(code == 2), np.asarray(rem))
    assert int(jnp.sum(ins)) > 0 and int(jnp.sum(rem)) > 0


def test_pack_codes_are_disjoint():
    idp = jnp.array([[True], [False], [False], [True]])
    dgp = jnp.array([[False], [True], [False], [False]])
    insw = jnp.array([[True], [True], [True], [False]])
    kind, thr = diag_carry.pack(idp, dgp, insw, insw, heatbath=True)
    assert thr is None
    assert np.asarray(kind)[:, 0].tolist() == [1, 2, 0, 0]
    num_ins = jnp.full((4, 1), 3.0)
    num_rem = jnp.full((4, 1), 7.0)
    kind, thr = diag_carry.pack(idp, dgp, num_ins, num_rem, heatbath=False)
    assert np.asarray(kind)[:, 0].tolist() == [1, 2, 0, 1]
    assert np.asarray(thr)[:, 0].tolist() == [3.0, 7.0, 7.0, 3.0]


# --- backend switch and compile cache ---------------------------------------


def test_gpu_kernels_off_on_cpu():
    assert jax.default_backend() == "cpu"
    assert backend.gpu_kernels() is False


def test_plain_xla_switches_kernels_off(fake_gpu):
    assert backend.gpu_kernels() is True
    with backend.plain_xla():
        assert backend.gpu_kernels() is False
    assert backend.gpu_kernels() is True


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_location(monkeypatch, tmp_path, env_dir):
    before = jax.config.jax_compilation_cache_dir
    try:
        if env_dir:
            want = str(tmp_path / env_dir)
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
            jax.config.update("jax_compilation_cache_dir", want)
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            want = os.path.join(REPO, ".jax_cache")
        assert compile_cache.enable() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_entry_scripts_fail_without_gpu(script):
    """No accelerator: non-zero exit and no result line on stdout."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, script)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"metric"' not in out.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    """Alone in a directory, without the package, it fails."""
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0 and '"ok"' not in out.stdout
