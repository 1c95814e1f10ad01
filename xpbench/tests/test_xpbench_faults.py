"""A run with the timed path broken underneath comes out not correct, once
for each fault the cell can have; a sound run comes out correct; and the
control (the reference one precision lower in the program's place) reads
several times what the program reads. At the cells' widths on 128 x 128
images, two pairs a call or step, on the CPU, with the cells' own limits.
The chip's readings at the cells' own sizes are in PERF.md."""
import time

import pytest
import torch

from xpbench import calibrate
from xpbench.harness import run_cell
from tiny import ALL_CELLS, cell, tiny_cell

SEED = 2 ** 31 + 77


def _run(name, faults=None):
    res = run_cell(tiny_cell(name), SEED, 0.5, 0, "cpu", time.perf_counter(),
                   faults)
    return res["correct"], res["compared"]


def _halve_calls(pipe):
    """Half of the batch left out: its answers are the first half's."""
    def run(img_o, img_t):
        h = img_o.shape[0] // 2
        out = pipe(img_o[:h], img_t[:h])
        return {k: torch.cat([v, v]) for k, v in out.items()}
    return run


def _alter_answer(pipe):
    """One match index changed where it is produced."""
    def run(img_o, img_t):
        out = pipe(img_o, img_t)
        idx = out["match_idx"].clone()
        idx[0, 0] = (idx[0, 0] + 1) % idx.shape[1]
        return dict(out, match_idx=idx)
    return run


def _alter_keypoint(pipe):
    """One keypoint moved by a pixel."""
    def run(img_o, img_t):
        out = pipe(img_o, img_t)
        kps = out["keypoints_optical"].clone()
        kps[0, 0, 1] = (kps[0, 0, 1] + 1) % img_o.shape[2]
        return dict(out, keypoints_optical=kps)
    return run


def _reset_leaves(which):
    """The program's copy of some leaves set back to their constant
    initial values (the reference keeps the drawn ones): the norms' scales
    to 1, the biases and norm shifts to 0, or the BatchNorm statistics to
    0 and 1, as a program that drops or misapplies them would read."""
    def fault(module):
        with torch.no_grad():
            for n, t in module.state_dict().items():
                leaf = n.rsplit(".", 1)[-1]
                if which == "scale" and leaf == "weight" and t.ndim == 1:
                    t.fill_(1.0)
                elif which == "bias" and leaf in ("bias", "q_bias", "v_bias"):
                    t.zero_()
                elif which == "bn_stats" and leaf in ("running_mean",
                                                      "running_var"):
                    t.fill_(float(leaf == "running_var"))
    fault.__name__ = f"reset_{which}"
    return fault


def _state_unchanged(step, state):
    state.apply_gradients = lambda grads, finite: None
    return step


SERVE = [c for c in ALL_CELLS if cell(c).traffic["kind"] == "serve"]
TRAIN = [c for c in ALL_CELLS if cell(c).traffic["kind"] == "train"]


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_sound_run_is_correct(name):
    assert _run(name)[0]


@pytest.mark.parametrize("fault", [_halve_calls, _alter_answer,
                                   _alter_keypoint])
@pytest.mark.parametrize("name", SERVE)
def test_serving_fault_is_caught(name, fault):
    assert not _run(name, {"serve": fault})[0]


@pytest.mark.parametrize("which", ["scale", "bias", "bn_stats"])
@pytest.mark.parametrize("name", SERVE)
def test_reset_leaves_are_caught(name, which):
    assert not _run(name, {"module": _reset_leaves(which)})[0]


@pytest.mark.parametrize("fault", [_state_unchanged, calibrate.half_batch])
@pytest.mark.parametrize("name", TRAIN)
def test_training_fault_is_caught(name, fault):
    assert not _run(name, {"train": fault})[0]


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_control_reads_higher(name):
    cell = tiny_cell(name)
    ctl = calibrate.control_readings(cell, SEED, "cpu")
    _, table = _run(name)
    prog = {k: v["value"] for k, v in table.items()}
    gaps = [k for k in prog if k.endswith("gap")]
    assert any(ctl[k] >= 3 * prog[k] for k in gaps), (ctl, prog)
