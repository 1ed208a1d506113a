"""The port's stage dumps (``utils/debug.py``) against the JAX package's,
on the same draw: every stage within 1e-10, the index and accept stages
exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import INITIAL_GUESS, configs, jax_draw, params, to_torch
from armadillocudalinearinterpolation_torch.utils import debug as port
from armadillocudalinearinterpolation_tpu.utils import debug as jaxdebug

# the two packages' f64 maps agree to ~1e-12 on this draw
# (tests/test_torch_map.py holds them to 1e-10); the discrete stages
# must agree exactly
ATOL = 1e-10
DISCRETE = ("init_spike_ind", "last_spike_ind", "crossed_spike_ind", "accept")


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    jcfg, pcfg = configs(n_neurons=512, n_real=4)
    jp, pp = params(sigma=0.1)
    beta = jax_draw(jcfg, jp)
    a = tmp_path_factory.mktemp("jax_dump")
    b = tmp_path_factory.mktemp("port_dump")
    jaxdebug.dump_map_stages(jcfg, jp, jax.random.PRNGKey(0),
                             jnp.asarray(INITIAL_GUESS), a)
    host = port.dump_map_stages(pcfg, pp, to_torch(beta),
                                torch.tensor(INITIAL_GUESS, dtype=torch.float64), b)
    return a, b, host, pcfg


def test_port_dump_matches_jax_dump(dumps):
    a, b, host, _ = dumps
    report = port.compare_dumps(a, b, atol=ATOL)
    assert set(report) == set(port.STAGES) | {"residual"}
    for stage in DISCRETE:
        np.testing.assert_array_equal(np.load(b / f"{stage}.npy"),
                                      np.load(a / f"{stage}.npy"))
        assert report[stage] == 0.0
    # the JAX package's own comparison reads the port's dump too
    assert jaxdebug.compare_dumps(b, a, atol=ATOL).keys() == report.keys()


def test_port_dump_shapes_and_residual(dumps):
    _, b, host, cfg = dumps
    for stage in port.STAGES:
        assert (b / f"{stage}.npy").exists(), stage
    assert host["coupling"].shape == (cfg.n_neurons,)
    assert host["averaged"].shape == (cfg.n_spikes,)
    assert host["last_spike_ind"].shape == (cfg.n_real, cfg.n_spikes)
    assert np.isfinite(host["residual"]).all()


def test_compare_dumps_names_differences(dumps, tmp_path):
    """A moved value, a NaN-pattern change and a missing stage are each
    reported by name."""
    a, _, _, _ = dumps
    c = tmp_path / "changed"
    c.mkdir()
    for f in a.glob("*.npy"):
        (c / f.name).write_bytes(f.read_bytes())
    res = np.load(c / "residual.npy")
    np.save(c / "residual.npy", res + 1e-6)
    avg = np.load(c / "averaged.npy")
    avg[0] = np.nan
    np.save(c / "averaged.npy", avg)
    (c / "coupling.npy").unlink()
    with pytest.raises(AssertionError) as err:
        port.compare_dumps(a, c)
    msg = str(err.value)
    assert "residual: max|diff|=" in msg
    assert "averaged" in msg and "NaN-pattern" in msg
    assert "coupling: missing in" in msg
