"""The GPU pair-EM kernel (kernels/em_gpu.py) and the choices around it.

On the CPU the kernel runs in Pallas interpret mode and is compared with
the XLA path (ops.em.pair_em) and the strict oracle (strict.pair_em_batch);
its Triton lowering for CUDA is checked without a card. Tests marked `gpu`
run the compiled kernel and skip where JAX has no GPU (see README)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ngsld_tpu.constants import ITER_MAX
from ngsld_tpu.kernels.em_gpu import block_shape, pair_em_gpu
from ngsld_tpu.ops.em import pair_em
from ngsld_tpu.utils.simulate import simulate


def _case(n_pairs, n_ind, seed, miss=True, dtype=np.float32):
    """n_pairs (site, site) pairs of simulated normal-space GLs + MAFs."""
    sim = simulate(n_ind=n_ind, n_sites=2 * n_pairs, seed=seed,
                   all_missing_site_rate=0.02 if miss else 0.0)
    gl = sim.gl / sim.gl.sum(axis=2, keepdims=True)
    gn1 = gl[:n_pairs].astype(dtype)
    gn2 = gl[n_pairs:2 * n_pairs].astype(dtype)
    eg = gl[..., 1] + 2 * gl[..., 2]
    maf = (eg.mean(axis=1) / 2).astype(dtype)
    return gn1, gn2, maf[:n_pairs], maf[n_pairs:2 * n_pairs]


@pytest.fixture
def x64():
    """f64 arrays need x64 mode; restored afterwards."""
    prev = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


def _nan_eq(a, b):
    both = np.isnan(a) & np.isnan(b)
    return np.where(both, 0, a), np.where(both, 0, b)


def _check(got, want, atol, knife_frac=None):
    """f within atol (NaN where both are NaN), n_used exact, n_iter equal
    except +-1 on at most knife_frac of the pairs (convergence knife-edges
    under a different summation order: ~1% of pairs in f32, far fewer in
    f64)."""
    if knife_frac is None:
        knife_frac = 0.02 if np.asarray(got[0]).dtype == np.float32 \
            else 0.005
    fg, fw = _nan_eq(np.asarray(got[0], np.float64),
                     np.asarray(want[0], np.float64))
    np.testing.assert_allclose(fg, fw, atol=atol, rtol=0)
    np.testing.assert_array_equal(np.asarray(got[2]), np.asarray(want[2]))
    d = np.abs(np.asarray(got[1]).astype(np.int64)
               - np.asarray(want[1]).astype(np.int64))
    assert d.max(initial=0) <= 1
    assert (d > 0).sum() <= max(1, int(knife_frac * len(d)))


TOL = {np.float32: 3e-5, np.float64: 1e-10}


# I = 1 and 3 are tiny cohorts, 37 / 100 pad one chunk, 129 and 300 span
# several chunks (the streamed path)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("ignore_miss", [False, True])
@pytest.mark.parametrize("n_ind", [1, 3, 37, 100, 129, 300])
def test_kernel_matches_xla(n_ind, ignore_miss, dtype, x64):
    a = [jnp.asarray(v) for v in
         _case(200, n_ind, seed=n_ind + 7, dtype=dtype)]
    want = pair_em(*a, ignore_miss)
    got = pair_em_gpu(*a, ignore_miss, interpret=True)
    assert got[0].dtype == a[0].dtype and got[0].shape == (200, 4)
    assert got[1].dtype == jnp.int32 and got[2].dtype == jnp.int32
    _check(got, want, TOL[dtype])


@pytest.mark.parametrize("ignore_miss", [False, True])
@pytest.mark.parametrize("n_ind", [3, 37, 100, 300])
def test_kernel_matches_strict(n_ind, ignore_miss, x64):
    """f64 kernel vs the bit-exact oracle (sequential reference loop)."""
    from ngsld_tpu import strict
    gn1, gn2, m1, m2 = _case(128, n_ind, seed=3 * n_ind, dtype=np.float64)
    want = strict.pair_em_batch(gn1, gn2, m1, m2, ignore_miss)
    got = pair_em_gpu(*map(jnp.asarray, (gn1, gn2, m1, m2)), ignore_miss,
                      interpret=True)
    _check(got, want, 1e-10)


@pytest.mark.parametrize("n_pairs", [1, 5, 63, 65, 511])
def test_pairs_not_a_block_multiple(n_pairs, x64):
    """Tail programs mask their out-of-range pairs: every real pair equals
    the XLA path and nothing is written past P."""
    a = [jnp.asarray(v) for v in
         _case(n_pairs, 12, seed=n_pairs, dtype=np.float64)]
    bp, _, _ = block_shape(12, 8)
    assert n_pairs % bp
    got = pair_em_gpu(*a, True, interpret=True)
    assert [x.shape[0] for x in got] == [n_pairs] * 3
    _check(got, pair_em(*a, True), 1e-10)


@pytest.mark.parametrize("bp,bi", [(4, 16), (8, 32), (16, 64), (2, 128)])
def test_block_shape_overrides_agree(bp, bi, x64):
    """Any power-of-two block (one chunk or several) computes the same EM;
    only the order of the individual sum changes."""
    a = [jnp.asarray(v) for v in _case(96, 100, seed=5, dtype=np.float64)]
    got = pair_em_gpu(*a, True, block_pairs=bp, block_ind=bi,
                      interpret=True)
    _check(got, pair_em(*a, True), 1e-10)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_all_missing_pairs_freeze(dtype, x64):
    """n_used == 0 (every individual missing at one site, with
    --ignore_miss_data): NaN frequencies frozen at n_iter 0, as in the
    reference."""
    gn1, gn2, m1, m2 = _case(40, 20, seed=11, dtype=dtype)
    gn1[::3] = 1.0 / 3.0
    a = [jnp.asarray(v) for v in (gn1, gn2, m1, m2)]
    f, n_iter, n_used = pair_em_gpu(*a, True, interpret=True)
    dead = np.zeros(40, bool)
    dead[::3] = True
    assert (np.asarray(n_used)[dead] == 0).all()
    assert (np.asarray(n_iter)[dead] == 0).all()
    assert np.isnan(np.asarray(f)[dead]).all()
    _check((f, n_iter, n_used), pair_em(*a, True), TOL[dtype])


@pytest.mark.parametrize("n_ind", [12, 37])
def test_iter_max_pairs(n_ind, x64):
    """Pairs that never reach EPSILON stop at ITER_MAX with the same
    frequencies as the XLA loop."""
    gn1, gn2, m1, m2 = _case(2000, n_ind, seed=1, dtype=np.float64)
    a = [jnp.asarray(v) for v in (gn1, gn2, m1, m2)]
    it = np.asarray(pair_em(*a, False)[1])
    slow = np.flatnonzero(it == ITER_MAX)[:24]
    assert len(slow) >= 8
    sel = np.concatenate([slow, np.flatnonzero(it < 20)[:40]])
    b = [v[sel] for v in a]
    got = pair_em_gpu(*b, False, interpret=True)
    assert (np.asarray(got[1])[:len(slow)] == ITER_MAX).all()
    _check(got, pair_em(*b, False), 1e-10)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_live_mask_freezes_dead_pairs(dtype, x64):
    """live=False pairs keep the f0 init with n_iter == ITER_MAX; live
    pairs are exactly the unmasked kernel's."""
    a = [jnp.asarray(v) for v in _case(100, 24, seed=9, dtype=dtype)]
    live = np.random.default_rng(0).random(100) < 0.5
    full = pair_em_gpu(*a, False, interpret=True)
    f, n_iter, n_used = pair_em_gpu(*a, False, jnp.asarray(live),
                                    interpret=True)
    np.testing.assert_array_equal(np.asarray(f)[live],
                                  np.asarray(full[0])[live])
    np.testing.assert_array_equal(np.asarray(n_iter)[live],
                                  np.asarray(full[1])[live])
    m1, m2 = np.asarray(a[2])[~live], np.asarray(a[3])[~live]
    f0 = np.stack([(1 - m1) * (1 - m2), (1 - m1) * m2,
                   m1 * (1 - m2), m1 * m2], axis=1)
    np.testing.assert_allclose(np.asarray(f)[~live], f0, rtol=1e-6)
    assert (np.asarray(n_iter)[~live] == ITER_MAX).all()
    np.testing.assert_array_equal(np.asarray(n_used),
                                  np.asarray(full[2]))
    _check((f, n_iter, n_used), pair_em(*a, False, live=jnp.asarray(live)),
           TOL[dtype])


def test_xla_live_mask_freezes_dead_lanes():
    """pair_em(live=...) (the ring steppers' XLA path): masked-out lanes
    return the f0 init with n_iter == ITER_MAX; live lanes are
    BIT-identical to the unmasked run."""
    rng = np.random.default_rng(7)
    P, I = 64, 10
    gl = rng.dirichlet([2.0, 1.0, 1.0], size=(2 * P, I)).astype(np.float32)
    eg = gl[..., 1] + 2 * gl[..., 2]
    maf = (eg.mean(axis=1) / 2).astype(np.float32)
    a = (jnp.asarray(gl[:P]), jnp.asarray(gl[P:]),
         jnp.asarray(maf[:P]), jnp.asarray(maf[P:]))
    live = jnp.asarray(rng.random(P) < 0.5)
    f_all, it_all, nu_all = jax.jit(pair_em, static_argnums=4)(*a, False)
    f_m, it_m, nu_m = jax.jit(
        lambda g1, g2, m1, m2, lv: pair_em(g1, g2, m1, m2, False, live=lv)
    )(*a, live)
    lv = np.asarray(live)
    np.testing.assert_array_equal(np.asarray(f_m)[lv],
                                  np.asarray(f_all)[lv])
    np.testing.assert_array_equal(np.asarray(it_m)[lv],
                                  np.asarray(it_all)[lv])
    m1, m2 = np.asarray(a[2])[~lv], np.asarray(a[3])[~lv]
    f0 = np.stack([(1 - m1) * (1 - m2), (1 - m1) * m2,
                   m1 * (1 - m2), m1 * m2], axis=1)
    np.testing.assert_array_equal(np.asarray(f_m)[~lv], f0)
    assert (np.asarray(it_m)[~lv] == ITER_MAX).all()
    np.testing.assert_array_equal(np.asarray(nu_m), np.asarray(nu_all))


# ---- Triton lowering (no card needed) ---------------------------------

@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("n_ind,ignore_miss", [(100, False), (2000, True)])
def test_kernel_lowers_for_cuda(n_ind, ignore_miss, dtype, x64):
    """The kernel lowers through the Triton route (resident and chunked
    cohorts, both dtypes); PTX compilation itself happens on the card."""
    import functools
    P = 4096
    args = ([jax.ShapeDtypeStruct((P, n_ind, 3), dtype)] * 2
            + [jax.ShapeDtypeStruct((P,), dtype)] * 2)
    fn = jax.jit(functools.partial(pair_em_gpu,
                                   ignore_miss_data=ignore_miss))
    text = fn.trace(*args).lower(lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in text
    assert "pair_em_gpu" in text


# ---- block shape and the platform / memory choices --------------------

@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("n_ind", [1, 100, 2000, 20000])
def test_block_shape_fits_registers(n_ind, itemsize):
    bp, bi, nw = block_shape(n_ind, itemsize)
    for v in (bp, bi, nw):
        assert v & (v - 1) == 0          # Triton needs powers of two
    assert 16 <= bi <= 128 and bp >= 1
    # ~12 live (BP, BI) tiles per chunk; 32-bit registers per thread
    regs = 12 * bp * bi * (itemsize // 4) / (32 * nw)
    assert regs <= 200


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_pair_em_for_known_platforms(platform):
    from ngsld_tpu.compute import pair_em_for
    fn = pair_em_for(platform)
    assert fn is (pair_em_gpu if platform == "gpu" else pair_em)


@pytest.mark.parametrize("platform", ["tpu", "rocm", "METAL", ""])
def test_pair_em_for_unknown_platform_raises(platform):
    from ngsld_tpu.compute import pair_em_for
    with pytest.raises(ValueError, match=repr(platform)):
        pair_em_for(platform)


@pytest.mark.parametrize("n_ind,itemsize,limit,want", [
    (100, 8, 60 * 2 ** 30, 2490368),    # H100 at 75%: ~2.5M pairs
    (100, 4, 60 * 2 ** 30, 4980736),
    (2000, 8, 60 * 2 ** 30, 114688),    # the 2,000-individual cohort
    (20000, 8, 60 * 2 ** 30, 16384),    # floor: one padding quantum
    (100, 8, 1 << 20, 16384),
])
def test_max_block_pairs(n_ind, itemsize, limit, want):
    from ngsld_tpu.compute import _BLOCK_QUANTUM, max_block_pairs
    got = max_block_pairs(n_ind, itemsize, limit)
    assert got == want and got % _BLOCK_QUANTUM == 0
    if got > _BLOCK_QUANTUM:   # the buffers fit half the limit
        assert got * (16 * n_ind * itemsize + 64) <= limit // 2


def test_max_block_pairs_monotone():
    from ngsld_tpu.compute import max_block_pairs
    caps = [max_block_pairs(i, 8, 40 * 2 ** 30) for i in (50, 100, 500,
                                                         2000)]
    assert caps == sorted(caps, reverse=True)
    assert max_block_pairs(100, 4, 2 ** 34) >= max_block_pairs(100, 8,
                                                               2 ** 34)


def test_device_bytes_limit_on_cpu():
    """The CPU backend reports no allocator limit: no cap is applied."""
    from ngsld_tpu.compute import device_bytes_limit
    assert device_bytes_limit() is None


@pytest.mark.parametrize("ignore_miss", [False, True])
def test_block_step_shapes(ignore_miss, x64):
    """The engine's gathered block step on the CPU: (P, 5) value rows in
    the table dtype, slim int8 n_iter rows without --ignore_miss_data."""
    from ngsld_tpu.compute import _compute_block_fn
    gn1, gn2, m1, m2 = _case(64, 10, seed=4, dtype=np.float64)
    gn = jnp.asarray(np.concatenate([gn1, gn2]))
    eg = gn[..., 1] + 2 * gn[..., 2]
    maf = jnp.asarray(np.concatenate([m1, m2]))
    sidx = jnp.asarray(np.stack([np.arange(64), np.arange(64) + 64])
                       .astype(np.int32))
    fm, im = _compute_block_fn(ignore_miss, "cpu", 1)(gn, eg, maf, sidx)
    assert fm.shape == (64, 5) and fm.dtype == jnp.float64
    assert im.shape == ((64, 2) if ignore_miss else (64, 1))
    assert im.dtype == (jnp.int16 if ignore_miss else jnp.int8)
    f, n_iter, _ = pair_em(gn[:64], gn[64:], maf[:64], maf[64:],
                           ignore_miss)
    np.testing.assert_array_equal(np.asarray(fm[:, 1:]), np.asarray(f))
    np.testing.assert_array_equal(np.asarray(im[:, 0]), np.asarray(n_iter))


def test_compile_cache_dir(monkeypatch):
    """Without JAX_COMPILATION_CACHE_DIR the cache lives in the checkout's
    .jax_cache; with it set, the program sets no directory of its own."""
    from ngsld_tpu import engine
    assert engine.DEFAULT_CACHE_DIR.endswith(".jax_cache")
    prev = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        jax.config.update("jax_compilation_cache_dir", None)
        engine.enable_compile_cache()
        assert (jax.config.jax_compilation_cache_dir
                == engine.DEFAULT_CACHE_DIR)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
        jax.config.update("jax_compilation_cache_dir", None)
        engine.enable_compile_cache()
        assert jax.config.jax_compilation_cache_dir is None
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


# ---- on the card --------------------------------------------------------

@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX finds none)")
    return jax.devices()[0]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n_ind", [100, 300])
def test_compiled_kernel_matches_xla(gpu, n_ind, dtype, x64):
    a = [jax.device_put(v, gpu) for v in
         _case(4096, n_ind, seed=2, dtype=dtype)]
    _check(pair_em_gpu(*a, True), pair_em(*a, True), TOL[dtype])
