"""The port's tutorials (srba_tpu_torch/examples): one for each tutorial of
the JAX package's ``examples/``, each running end to end on the CPU at a
reduced size.

As in tests/test_tutorials.py, the world factories of
``srba_tpu_torch.utils.datasets`` are clamped BEFORE a tutorial is imported
(tutorials bind them at import time), so the tutorials' own code paths run
at a size this suite can afford.  A tutorial passes if ``main(device="cpu")``
runs without error.
"""

import importlib
import inspect
import pathlib
import sys

import pytest
import torch

from tests.test_tutorials import _clamped

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_TUTORIALS = sorted(p.stem for p in (REPO / "examples").glob(
    "tutorial_*.py"))
TUTORIALS = sorted(p.stem for p in (REPO / "srba_tpu_torch" / "examples")
                   .glob("tutorial_*.py"))


def test_one_port_tutorial_per_jax_tutorial():
    assert TUTORIALS == JAX_TUTORIALS and len(TUTORIALS) == 6


@pytest.mark.parametrize("name", TUTORIALS)
def test_tutorial_runs(name, monkeypatch, capsys):
    import srba_tpu_torch.utils.datasets as D

    for factory in ("make_world_loop_2d", "make_world_loop_3d",
                    "make_world_loop_3d_large"):
        monkeypatch.setattr(D, factory, _clamped(getattr(D, factory)))
    mod_name = f"srba_tpu_torch.examples.{name}"
    sys.modules.pop(mod_name, None)
    try:
        mod = importlib.import_module(mod_name)
        assert inspect.signature(mod.main).parameters["device"].default \
            == "cuda"
        mod.main(device="cpu")
    finally:
        sys.modules.pop(mod_name, None)
    assert capsys.readouterr().out.strip()
