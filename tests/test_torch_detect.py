"""K4's plain version, ``ops.detect.detect_fused_plain``, against the JAX
package's fused Pallas kernel (interpret mode) and the port's non-fused stage.

On CPU tensors ``detect_fused`` takes the plain version, which is what
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the CUDA kernel to on
the card (bitwise). Bounds are ``tests/test_pallas_detect.py``'s: a cell
flips if ground differs beyond atol/rtol 1e-4 or confidence beyond 1e-5, and
at most ``max(3, n^2 / 10000)`` cells may flip over three seeds. Measured:
where only the local-min branch fires (the random layers) the outputs are
bitwise those of the JAX kernel and of the non-fused stage; where the main
update fires ("quiet" layers) up to a few hundred of 6,400 cells differ by
ulps, confidence from the JAX kernel (XLA turns divisions by constants
into reciprocal products) and ground from the non-fused stage (its sums
run in row-major order), none beyond the bounds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groundgrid_tpu.config import GroundGridConfig as JConfig
from groundgrid_tpu.core import detect as jdetect
from groundgrid_tpu.ops.pallas_detect import detect_ground_patches_fused
from tests.conftest import assert_layers_close
from tests.test_pallas_detect import _random_inputs, golden_detect_cases  # noqa: F401

from groundgrid_torch.config import GroundGridConfig as TConfig
from groundgrid_torch.core import detect as tdetect
from groundgrid_torch.data.synthetic import detect_layers
from groundgrid_torch.ops import detect as tops

torch.set_num_threads(1)

GEOMETRIES = {  # cells a side: (dimension, resolution), as tests/test_pallas_detect.py
    80: (40.0, 0.5),
    44: (22.0, 0.5),
    12: (6.0, 0.5),
    45: (16.65, 0.37),
}


def _configs(n):
    dim, res = GEOMETRIES[n]
    kw = dict(dimension=dim, resolution=res, max_points=1024, ray_steps=20,
              max_outlier_candidates=256)
    return JConfig(**kw), TConfig(**kw)


def _flips(a, b):
    (ga, ca), (gb, cb) = a, b
    return int(((~np.isclose(ga, gb, atol=1e-4, rtol=1e-4))
                | (~np.isclose(ca, cb, atol=1e-5, rtol=1e-5))).sum())


def _inputs(n, seed, variant="random"):
    """``detect_layers``; "dense": points x10 (the 12-cell grid skips every
    cell at the default density); "quiet": variance x0.01, so that cells
    take the main update (cpp:382-388) and not only the local-min branch."""
    layers = list(detect_layers(n, seed))
    if variant in ("dense", "quiet_dense"):
        layers[0] = layers[0] * np.float32(10.0)
    if variant in ("quiet", "quiet_dense"):
        layers[1] = layers[1] * np.float32(0.01)
    return layers


def _main_updates(layers, conf):
    """Cells whose confidence is neither kept nor the local-min branch's."""
    c0 = layers[4]
    local_min = np.minimum(c0 + np.float32(0.1), np.float32(0.5))
    return int(((conf != c0) & (conf != local_min)).sum())


@pytest.mark.parametrize("n,variant", [
    (12, "random"), (12, "dense"), (12, "quiet_dense"), (44, "random"), (44, "quiet"),
    (45, "random"), (45, "quiet"), (80, "random"), (80, "quiet"),
])
def test_fused_plain_vs_jax_kernel_and_nonfused(n, variant):
    jcfg, tcfg = _configs(n)
    jtab, ttab = jdetect.make_tables(jcfg), tdetect.make_tables(tcfg, "cpu")
    vs_kernel = vs_nonfused = changed = main = 0
    for seed in range(3):
        layers = _inputs(n, seed, variant)
        got = [t.numpy() for t in tops.detect_fused(tcfg, ttab, *map(torch.from_numpy, layers))]
        kernel = [np.asarray(t) for t in detect_ground_patches_fused(
            jcfg, jtab, *map(jnp.asarray, layers), interpret=True)]
        nonfused = [t.numpy() for t in tdetect.detect_ground_patches(
            tcfg, ttab, *map(torch.from_numpy, layers))]
        vs_kernel += _flips(got, kernel)
        vs_nonfused += _flips(got, nonfused)
        changed += int((got[1] != layers[4]).sum())
        main += _main_updates(layers, got[1])
    bound = max(3, n * n // 10000)
    assert vs_kernel <= bound, f"{vs_kernel} flips vs the JAX kernel at n={n}"
    assert vs_nonfused <= bound, f"{vs_nonfused} flips vs the non-fused stage at n={n}"
    assert changed > 0 or variant == "random" and n == 12  # the sweep did something
    assert (main > 0) == variant.startswith("quiet")


def test_wrapper_takes_plain_version_on_cpu():
    _, tcfg = _configs(45)
    tab = tdetect.make_tables(tcfg, "cpu")
    layers = [torch.from_numpy(a) for a in detect_layers(45, 5)]
    before = tops.detect_fused.launches
    a = tops.detect_fused(tcfg, tab, *layers)
    b = tops.detect_fused_plain(tcfg, tab, *layers)
    assert tops.detect_fused.launches == before  # no kernel launch on the CPU
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        tops.detect_fused(tcfg, tab, layers[0][:-1], *layers[1:])


@pytest.mark.parametrize("n", [12, 80])
def test_noninterior_passthrough_and_inputs_untouched(n):
    """Border cells pass ground / groundpatch through exactly; the inputs
    stay as they were (the step's spiral writes into the outputs)."""
    _, tcfg = _configs(n)
    layers = _inputs(n, 7, "quiet_dense")
    ts = [torch.from_numpy(a.copy()) for a in layers]
    g, c = tops.detect_fused(tcfg, tdetect.make_tables(tcfg, "cpu"), *ts)
    border = np.ones((n, n), dtype=bool)
    border[2:n - 2, 2:n - 2] = False
    np.testing.assert_array_equal(g.numpy()[border], layers[3][border])
    np.testing.assert_array_equal(c.numpy()[border], layers[4][border])
    assert (c.numpy()[~border] != layers[4][~border]).any()
    for t, a in zip(ts, layers):
        np.testing.assert_array_equal(t.numpy(), a)


def test_detect_layers_copy_bitwise():
    for n, seed in ((12, 0), (45, 2)):
        for a, b in zip(detect_layers(n, seed), _random_inputs(n, seed)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scan_idx", [0, 1])
def test_fused_plain_with_golden_inputs(small_config, golden_detect_cases, scan_idx):  # noqa: F811
    """The golden oracle's detect inputs and outputs (pre/post detect), with
    the bounds of ``tests/test_pallas_detect.py``."""
    kw = {f: getattr(small_config, f) for f in small_config.__dataclass_fields__}
    tcfg = TConfig(**kw)
    counts, variance, min_gh, g0, c0, g1, c1 = golden_detect_cases[scan_idx]
    new_g, new_c = tops.detect_fused(
        tcfg, tdetect.make_tables(tcfg, "cpu"),
        *(torch.from_numpy(np.ascontiguousarray(a, np.float32))
          for a in (counts, variance, min_gh, g0, c0)))
    assert_layers_close(new_g.numpy(), g1, "ground(post-detect,fused)", atol=1e-4)
    assert_layers_close(new_c.numpy(), c1, "groundpatch(post-detect,fused)", atol=1e-5)
