"""stereo_tpu_torch.solvers.trws_tables vs stereo_tpu.solvers.trws_tables:
TRW-S and BP over explicit pairwise tables (random per-pixel tables, shared
ones, Potts, truncated linear and quadratic), from zero and (TRW-S) from
warm messages.  CPU, float64, same numpy inputs.  Labels equal, energy, bound
and messages within 1e-10."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_tpu.solvers import trws_tables as j_tab
from stereo_tpu_torch.solvers import trws_tables as t_tab

torch.set_num_threads(1)

K, H, W = 4, 5, 6
RTOL = 1e-10


def _tables(kind, rng):
    if kind == "random":
        return rng.uniform(0, 2, (4, K, K, H, W))
    if kind == "shared":  # one table per direction, no per-pixel memory
        return rng.uniform(0, 2, (4, K, K, 1, 1))
    if kind == "potts":
        return np.asarray(j_tab.potts_table(K, 1.3, jnp.float64))
    if kind == "linear":
        return np.asarray(j_tab.truncated_linear_table(K, 0.7, 2.0,
                                                       jnp.float64))
    return np.asarray(j_tab.truncated_quadratic_table(K, 0.7, 2.0,
                                                      jnp.float64))


@pytest.mark.parametrize("name,args", [("potts_table", (K, 1.3)),
                                       ("truncated_linear_table",
                                        (K, 0.7, 2.0)),
                                       ("truncated_quadratic_table",
                                        (K, 0.7, 2.0))])
def test_table_builders_match_jax(name, args):
    got = getattr(t_tab, name)(*args, dtype=torch.float64, device="cpu")
    want = getattr(j_tab, name)(*args, dtype=jnp.float64)
    assert tuple(got.shape) == (1, K, K, 1, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _check(got, want):
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(float(got.energy), float(want.energy),
                               rtol=RTOL)
    np.testing.assert_allclose(float(got.lower_bound),
                               float(want.lower_bound), rtol=RTOL,
                               atol=1e-12)
    np.testing.assert_allclose(got.messages.numpy(), np.asarray(want.messages),
                               rtol=0, atol=1e-10)
    assert got.iterations == int(want.iterations)


@pytest.mark.parametrize("mode", ["trws", "bp"])
@pytest.mark.parametrize("kind", ["random", "shared", "potts", "linear",
                                  "quadratic"])
def test_solve_tables_matches_jax(kind, mode):
    rng = np.random.default_rng(len(kind) + len(mode))
    unary = rng.uniform(0, 5, (K, H, W))
    tables = _tables(kind, rng)
    # every sweep is run (max_relgap -inf): at an exact optimum the bound
    # can pass the energy by an ulp, and max_relgap=0 would stop there
    kw = dict(maxiter=5, max_relgap=-np.inf, mode=mode)
    want = j_tab.solve_tables(jnp.asarray(unary), jnp.asarray(tables), **kw)
    got = t_tab.solve_tables(torch.as_tensor(unary),
                             torch.as_tensor(tables), **kw)
    _check(got, want)
    if mode == "bp":
        assert float(got.lower_bound) == 0.0
        return
    assert float(got.lower_bound) <= float(got.energy) + 1e-9
    # warm start from the messages of the first call
    want = j_tab.solve_tables(jnp.asarray(unary), jnp.asarray(tables),
                              **kw, messages=want.messages)
    got = t_tab.solve_tables(torch.as_tensor(unary),
                             torch.as_tensor(tables), **kw,
                             messages=got.messages)
    _check(got, want)


def test_solve_tables_stopping_rule_matches_jax():
    """The relative-gap rule stops both at the same sweep."""
    rng = np.random.default_rng(3)
    unary = rng.uniform(0, 5, (K, H, W))
    tables = _tables("potts", rng) * 0.15
    kw = dict(maxiter=60, max_relgap=1e-3)
    want = j_tab.solve_tables(jnp.asarray(unary), jnp.asarray(tables), **kw)
    got = t_tab.solve_tables(torch.as_tensor(unary),
                             torch.as_tensor(tables), **kw)
    _check(got, want)
    assert 1 < got.iterations < 60
    with pytest.raises(ValueError, match="mode"):
        t_tab.solve_tables(torch.as_tensor(unary), torch.as_tensor(tables),
                           mode="icm")
