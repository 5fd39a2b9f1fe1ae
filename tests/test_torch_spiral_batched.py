"""K3 on a batch of grids, on the CPU: the plain walk over a leading axis.

The JAX fleet's unsorted branch runs its step under ``jax.vmap``, which
lifts the Pallas spiral to one call with a grid axis over the vehicles.
The port's counterpart takes (B, N, N) layers and a (B,) ``base_z``: one
launch of B blocks on the card, the plain walk over the batch on the CPU.
Held here, at B = 3 grids of 40^2 from a numpy seed, to the vmapped Pallas
kernel in interpret mode (the K3 contract of ``tests/test_pallas_spiral.py``:
confidence bitwise, heights atol 2e-5 / rtol 1e-5) and bitwise to the
stacked single plain calls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groundgrid_tpu.config import GroundGridConfig as JConfig
from groundgrid_tpu.ops.pallas_spiral import spiral_interpolation_pallas

from groundgrid_torch.config import GroundGridConfig as TConfig
from groundgrid_torch.ops import spiral

torch.set_num_threads(1)

KW = {"dimension": 20.0, "resolution": 0.5}  # 40^2 cells


def _grids(b, n, seed):
    """``b`` layer pairs and seeds, numpy f32: warm-like heights, 40 % of the
    cells confident."""
    rng = np.random.default_rng(seed)
    ground = rng.normal(0, 0.5, (b, n, n)).astype(np.float32)
    conf = np.where(rng.random((b, n, n)) < 0.4, rng.uniform(0.0, 1.0, (b, n, n)),
                    0.0).astype(np.float32)
    base_z = rng.normal(0.2, 0.3, b).astype(np.float32)
    return ground, conf, base_z


def _singles(cfg, ground, conf, base_z):
    """Each grid through its own plain call, stacked."""
    outs = [spiral.spiral_interpolation(cfg, torch.from_numpy(g.copy()),
                                        torch.from_numpy(c.copy()), torch.tensor(z))
            for g, c, z in zip(ground, conf, base_z)]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def test_batched_plain_vs_vmapped_pallas():
    jcfg, tcfg = JConfig(**KW), TConfig(**KW)
    assert tcfg.cell_count == 40
    ground, conf, base_z = _grids(3, tcfg.cell_count, 0)
    tg, tc = torch.from_numpy(ground.copy()), torch.from_numpy(conf.copy())
    g, c = spiral.spiral_interpolation(tcfg, tg, tc, torch.from_numpy(base_z))
    assert g is tg and c is tc  # in place, one grid a vehicle

    def one(gr, cf, z):
        return spiral_interpolation_pallas(jcfg, gr, cf, z, interpret=True)

    g_j, c_j = jax.vmap(one)(jnp.asarray(ground), jnp.asarray(conf), jnp.asarray(base_z))
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_j))
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), atol=2e-5, rtol=1e-5)

    g_s, c_s = _singles(tcfg, ground, conf, base_z)
    assert torch.equal(g.view(torch.int32), g_s.view(torch.int32))
    assert torch.equal(c.view(torch.int32), c_s.view(torch.int32))


@pytest.mark.parametrize("b", [1, 4])
def test_batched_plain_is_its_single_calls(b):
    """B = 1 and a batch whose grids differ in seed, confidence and base
    height: bitwise each grid's own call; the seeds land on each center."""
    cfg = TConfig(dimension=12.0, resolution=0.5, ray_steps=24)
    n, m = cfg.cell_count, cfg.center_cell
    ground, conf, base_z = _grids(b, n, 7 + b)
    conf[0] = 0.0  # a grid without confidence
    g, c = spiral.spiral_interpolation(cfg, torch.from_numpy(ground.copy()),
                                       torch.from_numpy(conf.copy()), torch.from_numpy(base_z))
    g_s, c_s = _singles(cfg, ground, conf, base_z)
    assert torch.equal(g.view(torch.int32), g_s.view(torch.int32))
    assert torch.equal(c.view(torch.int32), c_s.view(torch.int32))
    np.testing.assert_array_equal(g[:, m, m].numpy(), base_z)


def test_batched_rejects_mismatched_layers():
    cfg = TConfig(dimension=12.0, resolution=0.5, ray_steps=24)
    n = cfg.cell_count
    with pytest.raises(ValueError):
        spiral.spiral_interpolation(cfg, torch.zeros(2, n, n), torch.zeros(3, n, n),
                                    torch.zeros(2))
    with pytest.raises(ValueError):  # the ring-range entry keeps its single-grid form
        spiral.spiral_interpolation_rings(cfg, torch.zeros(2, n, n), torch.zeros(2, n, n),
                                          torch.zeros(2), 1, 2, True)
