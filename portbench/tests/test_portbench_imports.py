"""No JAX on the chip: the benchmark, run end to end, loads neither JAX nor
the JAX package, and its reference loads nothing of the port either.
Top-level module names are compared whole (the port's name begins with the
JAX package's)."""

import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "groundgrid_tpu"}


def loaded_after(code: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.', 1)[0] for m in sys.modules})))"],
        cwd=REPO, capture_output=True, text=True, timeout=600, check=True)
    return set(out.stdout.split())


def test_a_run_loads_no_jax(tmp_path):
    code = ("import sys, torch; sys.path.insert(0, '.'); torch.set_num_threads(1)\n"
            "from portbench.tests import tiny\n"
            "from portbench.bench import run_cell\n"
            f"root = tiny.write({str(tmp_path)!r})\n"
            "for w in ('tinylive.tiny', 'tinyfleet.tiny'):\n"
            "    run_cell(root, w, 1, 3.0, True, 'cpu', log=lambda line: None)\n")
    names = loaded_after(code)
    assert "groundgrid_torch" in names and "portbench" in names
    assert not names & FORBIDDEN


@pytest.mark.parametrize("module", ["portbench.reference.groundgrid", "portbench.check",
                                    "portbench.control"])
def test_reference_loads_nothing_of_the_port(module):
    names = loaded_after(f"import sys; sys.path.insert(0, '.')\nimport {module}\n")
    assert not names & (FORBIDDEN | {"groundgrid_torch"})


def test_the_check_flags_a_loaded_jax_package():
    from portbench.bench import forbidden_modules

    sys.modules["groundgrid_tpu"] = type(sys)("groundgrid_tpu")
    try:
        assert forbidden_modules() == ["groundgrid_tpu"]
    finally:
        del sys.modules["groundgrid_tpu"]
    sys.modules["groundgrid_torchlike"] = type(sys)("groundgrid_torchlike")
    try:
        assert "groundgrid_torchlike" not in forbidden_modules()
    finally:
        del sys.modules["groundgrid_torchlike"]
