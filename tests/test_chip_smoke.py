"""CPU rehearsal of chip_smoke.py: every phase function at a tiny size,
with the pallas kernels in interpret mode (the script itself refuses to run
without a GPU)."""

import os
import sys

import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402


@pytest.fixture(scope="module")
def case():
    return cs.Case(600, 64, 48, backend="pallas", interpret=True)


def test_refuses_cpu():
    with pytest.raises(cs.SmokeError, match="no GPU"):
        cs.phase_device()


def test_render_phases(case):
    info = cs.phase_device(require_gpu=False)
    assert info["platform"] == "cpu"
    cs.phase_compile(case)
    assert cs.phase_main_path(case) > 0.0
    fwd = cs.compare_forward(case)
    assert fwd["n_contrib_equal_share"] == 1.0
    grads = cs.compare_grads(case)
    assert set(grads) >= {"means", "sh", "opacity_logits"}
    res = cs.phase_timing(case, iters=1)
    assert res["oracle_ms"] is not None and res["kernel_ms"] > 0.0


def test_train_phase(tmp_path):
    losses = cs.phase_train(n=200, width=64, height=48, steps=3, views=2,
                            workdir=str(tmp_path / "train"))
    assert len(losses) >= 3


def test_four_cards_phase():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    cs.phase_four_cards(n_render=(400, 64, 64), n_train=(400, 64, 32),
                        interpret=True)
