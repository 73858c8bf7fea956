"""The port's eager oracle, soft-error hook and plane scrub against the JAX
reference (``repro.core.approx_store``, ``repro.memory``).

The oracle draws the same threefry words as ``jax.random.uniform`` under
the same key, so stored words, flips and errors are exact. Energy is
summed in another order: the port takes the float64 sum over planes of
(integer flips x plane energy) and rounds it once, so it must equal that
sum computed here in numpy to float32 rounding; the reference adds its n
= elements x bits float32 terms in float32, so it is held within the
bound of such a sum, n x 2^-24 relative, of the same value (measured:
up to 2.3e-6 relative at 133 float32 elements). The lane-versus-oracle
1e-5 check that the reference itself fails (ROADMAP §C.1) is not
repeated."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import memory as jmemory
from repro.core import approx_store as japs
from repro.core.priority import Priority as JP
from repro.memory import backends as jbackends
from repro.memory.plan import leaf_vectors as jleaf_vectors
from repro_torch import memory as tmemory
from repro_torch import rng
from repro_torch.core import approx_store as taps
from repro_torch.core import write_driver as twd
from repro_torch.core.priority import Priority as TP
from repro_torch.memory import backends as tbackends
from repro_torch.memory.plan import leaf_vectors as tleaf_vectors

CPU = torch.device("cpu")
F32_ROUNDING = 2.0 ** -24
#: the reference keeps whichever level table its process computed first;
#: the one computed outside compile-time evaluation differs from the
#: port's in the last bit of some latencies and energies (ROADMAP §C)
TABLE_RTOL = 1e-6
DTYPES = {"float32": (torch.float32, jnp.float32, torch.int32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, torch.int16),
          "int8": (torch.int8, jnp.int8, torch.int8)}


def _pair(shape, dt, seed):
    """(old, new) as torch tensors, with a quarter of the elements equal."""
    r = np.random.default_rng(seed)
    tdt = DTYPES[dt][0]
    if dt == "int8":
        a, b = (torch.from_numpy(r.integers(-128, 128, shape).astype(np.int8))
                for _ in range(2))
    else:
        a, b = (torch.from_numpy(r.standard_normal(shape).astype(
            np.float32)).to(tdt) for _ in range(2))
    keep = torch.from_numpy(r.random(shape) < 0.25)
    return a, torch.where(keep, a, b)


def _to_jax(t):
    if t.dtype == torch.bfloat16:
        return jax.lax.bitcast_convert_type(
            jnp.asarray(t.view(torch.int16).numpy()), jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _bits(t):
    return t.view(DTYPES[_name(t.dtype)][2]).numpy()


def _jbits(a, dt):
    it = {"float32": jnp.int32, "bfloat16": jnp.int16, "int8": jnp.int8}[dt]
    return np.asarray(jax.lax.bitcast_convert_type(a, it))


def _name(dtype):
    return {v[0]: k for k, v in DTYPES.items()}[dtype]


def _key(seed):
    return rng.fold_in(rng.PRNGKey(seed), 5)


def _check_energy(port_pj, ref_pj, old, new, lv, n_terms):
    """The port's energy is the float64 per-plane sum rounded once; the
    reference's a float32 sum of ``n_terms`` terms of the same value."""
    nbits = old.element_size() * 8
    o = _bits(old).astype(np.int64).ravel()[:, None]
    n = _bits(new).astype(np.int64).ravel()[:, None]
    sh = np.arange(nbits)
    flip = (((o ^ n) >> sh) & 1).astype(bool)
    up = flip & (((n >> sh) & 1) == 1)
    exact = (up.sum(0) * lv.eb01.double().numpy()
             + (flip & ~up).sum(0) * lv.eb10.double().numpy()).sum()
    np.testing.assert_allclose(port_pj, np.float32(exact),
                               rtol=F32_ROUNDING)
    np.testing.assert_allclose(ref_pj, exact, rtol=n_terms * F32_ROUNDING)


@pytest.mark.parametrize("shape", [(5,), (33,), (7, 19), (129,)])
@pytest.mark.parametrize("dt", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("level", ["LOW", "MID"])
def test_backend_parity_matrix(shape, dt, level):
    """``oracle`` through ``memory.write`` against the reference oracle
    under the same key: stored words, flips and errors exact; the lane
    twin's flips equal the oracle's."""
    seed = 100 + 10 * len(shape) + shape[-1] + 7 * list(DTYPES).index(dt)
    old, new = _pair(shape, dt, seed)
    key = _key(seed)
    ts, tst = tmemory.write(key, old, new, level=TP[level],
                            backend="oracle")
    js, jst = jmemory.write(jnp.asarray(key), _to_jax(old), _to_jax(new),
                            level=JP[level], backend="oracle")
    np.testing.assert_array_equal(_bits(ts), _jbits(js, dt))
    th, jh = tst.host_dict(), jst.host_dict()
    for k in ("flips01", "flips10", "bit_errors", "bits_total",
              "soft_strikes"):
        assert th[k] == jh[k], k
    np.testing.assert_allclose(th["latency_ns"], jh["latency_ns"],
                               rtol=TABLE_RTOL)
    _check_energy(th["energy_pj"], jh["energy_pj"], old, new,
                  tleaf_vectors(old.dtype, TP[level], CPU),
                  old.numel() * old.element_size() * 8)
    # write semantics: every stored bit comes from old or new
    o, n, s = _bits(old), _bits(new), _bits(ts)
    assert not np.any((s ^ n) & (s ^ o))
    _, lst = tmemory.write(key, old, new, level=TP[level],
                           backend="lanes_ref")
    lh = lst.host_dict()
    assert (lh["flips01"], lh["flips10"]) == (th["flips01"], th["flips10"])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_legacy_entry_points_match_reference(dt):
    old, new = _pair((9, 14), dt, 7)
    key = _key(7)
    # both given the port's table: the reference's default would cache
    # its level table outside compile-time evaluation for the process
    table = twd.level_table()
    ts, tst = taps.approx_write_with_stats(key, old, new, TP.MID, table)
    js, jst = japs.approx_write_with_stats(
        jnp.asarray(key), _to_jax(old), _to_jax(new), JP.MID,
        {k: jnp.asarray(v) for k, v in table.items()})
    np.testing.assert_array_equal(_bits(ts), _jbits(js, dt))
    for f in ("bits_written", "bits_total", "bit_errors", "flips_0to1",
              "flips_1to0", "latency_ns"):
        assert float(getattr(tst, f)) == float(getattr(jst, f)), f
    _check_energy(float(tst.energy_pj), float(jst.energy_pj), old, new,
                  tleaf_vectors(old.dtype, TP.MID, CPU),
                  old.numel() * old.element_size() * 8)
    np.testing.assert_array_equal(
        _bits(taps.approx_write(key, old, new, TP.MID, table)), _bits(ts))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("hardened", [False, True])
def test_inject_soft_errors_matches_reference(dt, hardened):
    x, _ = _pair((37, 21), dt, 11)
    key = _key(11)
    ty, strikes = taps.soft_error_strikes(key, x, 0.02, hardened)
    jy = japs.inject_soft_errors(jnp.asarray(key), _to_jax(x), 0.02,
                                 protect_exponent=hardened)
    np.testing.assert_array_equal(_bits(ty), _jbits(jy, dt))
    np.testing.assert_array_equal(
        _bits(taps.inject_soft_errors(key, x, 0.02, hardened)), _bits(ty))
    nbits = 8 * x.element_size()
    d = (_bits(x) ^ _bits(ty)).astype(np.int64) & ((1 << nbits) - 1)
    assert int(strikes) == sum(bin(int(v)).count("1") for v in d.ravel())
    assert int(strikes) > 0
    if hardened:  # sign and exponent planes never strike
        assert not np.any(d >> (7 if dt == "bfloat16" else 23))


def test_planes_scrub_on_a_float64_leaf():
    """Widths without lane packing: the lane quadruple is None, the write
    falls back to the oracle and the scrub to the exact plane scrub; held
    against the reference's under x64."""
    r = np.random.default_rng(21)
    stored = torch.from_numpy(r.standard_normal((13, 5)))
    mask = torch.from_numpy(
        (r.integers(0, 2 ** 62, (13, 5)) & r.integers(0, 2 ** 62, (13, 5))
         & r.integers(0, 2 ** 62, (13, 5))).astype(np.int64))
    tlv = tleaf_vectors(torch.float64, TP.MID, CPU)
    assert tlv.thr01 is None and tlv.wer01.shape == (64,)
    ts, tres, tst = tbackends.get_backend("lanes_ref").leaf_scrub(
        _key(1), stored, mask, tlv)
    with jax.enable_x64(True):
        jlv = jleaf_vectors(jnp.float64, JP.MID)
        js, jres, jst = jbackends._planes_scrub(
            jnp.asarray(stored.numpy()),
            jnp.asarray(mask.numpy()).view(jnp.uint64), jlv)
        jh = jst.host_dict()
        js = np.asarray(js)
        jres = np.asarray(jres)
    np.testing.assert_array_equal(ts.numpy(), js)
    assert not tres.any() and not jres.any()
    th = tst.host_dict()
    for k in ("flips01", "flips10", "bits_total"):
        assert th[k] == jh[k], k
    np.testing.assert_allclose(th["latency_ns"], jh["latency_ns"],
                               rtol=TABLE_RTOL)
    n_terms = stored.numel() * 64
    np.testing.assert_allclose(th["energy_pj"], jh["energy_pj"],
                               rtol=n_terms * F32_ROUNDING)
    # the 8-byte write goes through the oracle on every backend
    new = stored + 1.0
    a = tmemory.write(_key(2), stored, new, level=TP.LOW, backend="oracle")
    b = tmemory.write(_key(2), stored, new, level=TP.LOW,
                      backend="lanes_ref")
    assert torch.equal(a[0].view(torch.int64), b[0].view(torch.int64))
    assert a[1].host_dict() == b[1].host_dict()


def test_approx_store_shim_matches_reference():
    x, y = _pair((40,), "float32", 3)
    ts, js = taps.ApproxStore(), japs.ApproxStore()
    for i, (name, val, lvl) in enumerate((("a", x, "LOW"), ("a", y, "MID"),
                                          ("b", y, "LOW"))):
        k = _key(30 + i)
        ts, tv = ts.write(k, name, val, TP[lvl])
        js, jv = js.write(jnp.asarray(k), name, _to_jax(val), JP[lvl])
        np.testing.assert_array_equal(_bits(tv), _jbits(jv, "float32"))
    assert ts.bits_written == js.bits_written
    assert ts.bit_errors == js.bit_errors
    np.testing.assert_allclose(ts.latency_ns, js.latency_ns,
                               rtol=TABLE_RTOL)
    np.testing.assert_allclose(ts.energy_pj, js.energy_pj,
                               rtol=40 * 32 * F32_ROUNDING)
    np.testing.assert_array_equal(_bits(ts.read("b")),
                                  _jbits(js.read("b"), "float32"))
