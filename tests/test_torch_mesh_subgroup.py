"""A mesh of fewer ranks than the process group: ``make_mesh(n)`` takes the
group's first n ranks, as JAX's ``make_mesh(n)`` takes the first n devices
(``xpoint_tpu/parallel/mesh.py:18-36``), and raises, as JAX's does, when n
is more than there are. The ranks run on the CPU over gloo through
``parallel.launch``; the rank bodies are in tests/torch_parallel_ranks.py.

``Trainer(n_devices=1)`` in a 2-rank group is held bit for bit to the
one-rank Trainer in this process on the same config, data and seed (two
epochs, the Adam moments, the step, the BatchNorm statistics), with the
same CPU thread count on both sides; the other rank takes no step and
returns without a collective.
"""
import os

import torch

from xpoint_tpu_torch.parallel import launch
from xpoint_tpu_torch.trainer import Trainer

import torch_parallel_ranks as ranks
from test_torch_trainer import synth_config
from torch_env import torch_env  # noqa: F401 (autouse)

LAUNCH_S = 300


def test_trainer_on_the_first_rank_of_two_equals_one_rank(tmp_path):
    cfg = synth_config()
    got = launch(ranks.subgroup_trainer, 2,
                 args=({"cfg": cfg, "root": str(tmp_path / "two")},),
                 devices=["cpu", "cpu"], timeout=LAUNCH_S, threads=2)
    assert got["mesh"] == (0, 1, True, True)
    assert "asked for 3 devices" in got["make_mesh_3"]
    assert "xpoint_tpu_torch.parallel.launch" in got["make_mesh_3"]
    # (member, steps, trained) of each rank: rank 0 took the 2 x 4 steps
    assert got["facts"].tolist() == [[1.0, 4.0, 1.0], [0.0, 0.0, 0.0]]
    assert got["files"] == ["e1.pt", "e2.pt", "latest.pt", "params.yaml"]

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        one = Trainer(cfg, str(tmp_path / "one"), seed=0, device="cpu",
                      dataset=ranks.FrozenSingleImages(8, seed=1),
                      val_dataset=ranks.FrozenSingleImages(4, seed=2))
        assert one.mesh.size == 1 and one.mesh.member
        one.train()
    finally:
        torch.set_num_threads(threads)
    want = ranks._trainer_tensors(one)
    assert len(got["tensors"]) == len(want)
    for g, w in zip(got["tensors"], want):
        assert torch.equal(g, w)
    assert sorted(os.listdir(tmp_path / "one")) == got["files"]


def test_mesh_of_two_in_a_group_of_three():
    got = launch(ranks.subgroup_collectives, 3,
                 devices=["cpu", "cpu", "cpu"], timeout=LAUNCH_S, threads=1)
    assert got["sum"] == 3.0
    assert got["rows"] == [0, 1, 2, 3]
    # (member, size, rank) of each rank
    assert got["facts"].tolist() == [[1.0, 2.0, 0.0], [1.0, 2.0, 1.0],
                                     [0.0, 2.0, 2.0]]
