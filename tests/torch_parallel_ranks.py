"""Rank bodies of the 2-rank CPU tests (tests/test_torch_parallel*.py).

The launcher spawns each rank in a fresh interpreter that imports this
module to find its function, so it imports torch, numpy and the port, never
JAX. Each body runs every case of its test file in one launch and returns
rank 0's results; the tests compare them with the JAX package's 2-device
programs and with the port on one device."""
import os
import shutil

import numpy as np
import torch

from xpoint_tpu_torch.data.device_dataset import (load_resident_pair_data,
                                                  make_resident_batch_fn)
from xpoint_tpu_torch.eval import make_sharded_pair_pipeline
from xpoint_tpu_torch.losses import XPointLoss
from xpoint_tpu_torch.models import build_xpoint
from xpoint_tpu_torch.models.vssm import SS2D
from xpoint_tpu_torch.parallel import (make_mesh, ring_linear_scan,
                                       ring_mesh, ring_selective_scan,
                                       shard_batch)
from xpoint_tpu_torch.parallel.mesh import all_gather, all_reduce, collectives
from xpoint_tpu_torch.selfsup.export import NumpySink, export_keypoints
from xpoint_tpu_torch.selfsup.homographic_adaptation import make_sharded_ha_fn
from xpoint_tpu_torch.train import TrainState, make_optimizer, make_train_step
from xpoint_tpu_torch.trainer import Trainer

T = torch.from_numpy


def same_on_every_rank(x, mesh):
    """True when every rank holds the same bits of ``x``."""
    g = all_gather(x.detach().reshape(-1), mesh)
    return bool(all(torch.equal(g[0], g[r]) for r in range(mesh.size)))


# ---- ring scan, SS2D, serving, HA, export, mesh errors ---------------------

def ha_prob_fn(img, is_optical):
    """An analytic detector (a fixed 3x3 conv and a sigmoid per spectrum)."""
    k = torch.tensor([[0.2, -0.1, 0.3], [0.5, 1.0, -0.4], [0.1, 0.2, -0.3]])
    k = (k if is_optical else k.flip(0))[None, None]
    z = torch.nn.functional.conv2d(img.permute(0, 3, 1, 2), k, padding=1)
    return torch.sigmoid(2.0 * z[:, 0] - 1.0) * 0.3


class PairImages:
    """In-memory pairs with the dataset interface ``export_keypoints``
    reads."""

    def __init__(self, img_o, img_t):
        self.img_o, self.img_t = img_o, img_t

    def __len__(self):
        return len(self.img_o)

    def __getitem__(self, i):
        return {"optical": {"image": self.img_o[i]},
                "thermal": {"image": self.img_t[i]}}

    def get_name(self, i):
        return f"sample_{i:04d}"


def parallel_cases(inp):
    mesh = make_mesh(2)
    out = {"mesh": (mesh.rank, mesh.size, str(mesh.device))}
    try:
        make_mesh(4)
    except ValueError as e:
        out["make_mesh_4"] = str(e)

    # ring_linear_scan and its gradients (the rank-mean convention)
    a = T(inp["ring_a"]).requires_grad_()
    b = T(inp["ring_b"]).requires_grad_()
    h = ring_linear_scan(a, b, mesh)
    (h ** 2).sum().backward()
    out["ring_h"] = h.detach()
    out["ring_ga"] = all_reduce(a.grad, mesh) / mesh.size
    out["ring_gb"] = all_reduce(b.grad, mesh) / mesh.size
    out["ring_same"] = same_on_every_rank(h, mesh)
    try:
        ring_linear_scan(a[:-1], b[:-1], mesh)
    except ValueError as e:
        out["ring_odd"] = str(e)

    # ring_selective_scan in selective_scan's layout, through the backend
    from xpoint_tpu_torch.ops.selective_scan import selective_scan
    args = [T(x) for x in inp["sel"]]
    with ring_mesh(mesh):
        out["sel_y"] = selective_scan(*args, backend="ring")
    out["sel_y_direct"] = ring_selective_scan(*args, mesh=mesh)

    # SS2D with the ring backend, the weights of the JAX block
    ss = SS2D(**inp["ss2d_kw"], scan_backend="ring")
    ss.load_state_dict(inp["ss2d_sd"])
    with ring_mesh(mesh), torch.no_grad():
        out["ss2d_y"] = ss(T(inp["ss2d_x"]))

    # sharded serving of the tiny model
    tm, _ = build_xpoint(inp["model_cfg"], device=mesh.device)
    tm.load_state_dict(inp["model_sd"])
    run = make_sharded_pair_pipeline(tm, inp["pipe_hw"], mesh,
                                     **inp["pipe_kw"])
    img_o, img_t = T(inp["pipe_o"]), T(inp["pipe_t"])
    c0 = collectives.count
    run.base(mesh.rows(img_o), mesh.rows(img_t))
    inside = collectives.count - c0
    c0 = collectives.count
    out["pipe"] = run(img_o, img_t)
    out["pipe_collectives"] = {"inside": inside,
                               "call": collectives.count - c0,
                               "keys": len(out["pipe"])}
    # RANSAC on the device: the global batch's noise, this rank's rows
    out["pipe_ransac"] = make_sharded_pair_pipeline(
        tm, inp["pipe_hw"], mesh, estimate_homography=True,
        ransac_iters=16, **inp["pipe_kw"])(
            img_o, img_o, torch.Generator().manual_seed(3))

    # sharded HA of the analytic detector
    run_ha, _ = make_sharded_ha_fn(ha_prob_fn, inp["ha_cfg"], mesh)
    c0 = collectives.count
    out["ha"] = run_ha(T(inp["ha_o"]), T(inp["ha_t"]), T(inp["ha_hs"]))
    out["ha_collectives"] = collectives.count - c0

    # the label export of the tiny model: rank 0 alone holds the sink
    sink = NumpySink() if mesh.rank == 0 else None
    ds = PairImages(inp["export_o"], inp["export_t"])
    out["export_n"] = export_keypoints(
        tm, ds, sink, inp["export_ha"], inp["export_pred"], seed=3,
        batch=2, mesh=mesh)
    out["export"] = sink.groups if sink is not None else None
    return out


def failing_rank(mode):
    """Rank 1 raises (or hangs) while rank 0 waits in a collective."""
    mesh = make_mesh(2)
    if mesh.rank == 1:
        if mode == "raise":
            raise RuntimeError("rank 1 fails on purpose")
        import time
        time.sleep(3600)
    all_reduce(torch.ones(3), mesh)
    return "unreachable"


# ---- data-parallel training ------------------------------------------------

def _torch_tree(x):
    if isinstance(x, dict):
        return {k: _torch_tree(v) for k, v in x.items()}
    return T(np.array(x, copy=True))


def _state(state):
    opt = state.optimizer
    return {"module": {k: v.detach().clone()
                       for k, v in state.module.state_dict().items()},
            "mu": opt.mu.clone(), "nu": opt.nu.clone(),
            "count": int(opt.count), "step": int(state.step)}


def dp_steps(case, mesh):
    """``case``'s global batches through make_train_step on ``mesh`` (this
    rank's rows of each): the components and Adam's mu of every step, and
    the state."""
    tm, _ = build_xpoint(case["cfg"], device=mesh.device)
    tm.load_state_dict(case["sd"])
    state = TrainState(tm, make_optimizer({"learningrate": case["lr"]})[0])
    step = make_train_step(tm, XPointLoss(case["loss"]),
                           takes_pair=case["pair"], mesh=mesh)
    gen = torch.Generator().manual_seed(case["gen_seed"])
    comps, mus = [], []
    for batch in case["batches"]:
        c = step(state, shard_batch(_torch_tree(batch), mesh), gen)
        comps.append({k: float(v) for k, v in c.items()})
        mus.append(state.optimizer.mu.clone())
        if len(mus) == 1:
            buffers_first = {k: v.clone() for k, v in tm.named_buffers()}
    flat = torch.cat([p.detach().reshape(-1) for p in state.params]
                     + [b.reshape(-1) for b in tm.buffers()])
    return {"comps": comps, "state": _state(state), "mus": mus,
            "buffers_first": buffers_first,
            "same_on_every_rank": same_on_every_rank(flat, mesh)}


def resident_batches(inp, mesh):
    """make_resident_batch_fn's batch on ``mesh``, gathered over the
    ranks."""
    from xpoint_tpu_torch.data.synthetic_pairs import SyntheticPairs
    ds = SyntheticPairs(**inp["pairs"])
    data, meta = load_resident_pair_data(ds, device=mesh.device)
    fn = make_resident_batch_fn(ds.config, meta, hm_input=True, mesh=mesh)
    gen = torch.Generator().manual_seed(7)
    out = []
    for idx in inp["idx"]:
        batch = fn(gen, {"data": data, "idx": torch.tensor(idx)})
        out.append(_gather_tree(batch, mesh))
    return out


def _gather_tree(x, mesh):
    from xpoint_tpu_torch.parallel.mesh import gather_rows
    if isinstance(x, dict):
        return {k: _gather_tree(v, mesh) for k, v in x.items()}
    return gather_rows(x, mesh)


class FrozenSingleImages:
    """A single-image dataset in memory (SyntheticShapes' sample layout),
    as tests/test_torch_trainer.py's."""

    def __init__(self, n, S=32, seed=0):
        rng = np.random.default_rng(seed)
        self.images = rng.uniform(size=(n, S, S, 1)).astype(np.float32)
        self.kps = np.zeros((n, S, S), np.float32)
        cells = rng.uniform(size=(n, S // 8, S // 8)) < 0.4
        for b, i, j in zip(*np.nonzero(cells)):
            self.kps[b, 8 * i + rng.integers(8),
                     8 * j + rng.integers(8)] = 1.0

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return {"image": self.images[i], "keypoints": self.kps[i],
                "valid_mask": np.ones(self.kps[i].shape, bool),
                "is_optical": np.array([i % 2 == 0])}

    def returns_pair(self):
        return False


def _trainer_tensors(t):
    opt = t.state.opt_state
    return [x.clone() for x in (*t.module.state_dict().values(), *opt["mu"],
                                *opt["nu"], opt["count"], t.state.step)]


def trainer_run(inp, mesh):
    """Two epochs of the port's Trainer on this rank, its losses recorded,
    then a resume from e1 in a fresh directory: does it end bit for bit
    where the straight run ended (on every rank)?"""
    train_ds = FrozenSingleImages(8, seed=1)
    val_ds = FrozenSingleImages(4, seed=2)
    root = inp["root"]
    t = Trainer(inp["cfg"], os.path.join(root, "port"), seed=0,
                device="cpu", dataset=train_ds, val_dataset=val_ds)
    t.module.load_state_dict(inp["sd"])
    losses = {"train": [], "val": []}
    inner_t, inner_v = t.train_step, t.eval_step

    def rec_t(*a):
        c = inner_t(*a)
        losses["train"].append(float(c["loss"]))
        return c

    def rec_v(*a):
        out = inner_v(*a)
        losses["val"].append(float(out[0]))
        return out
    t.train_step, t.eval_step = rec_t, rec_v
    t.train()
    straight = _trainer_tensors(t)
    resumed_dir = os.path.join(root, "resumed")
    if mesh.rank == 0:
        os.makedirs(resumed_dir)
        shutil.copy(os.path.join(root, "port", "e1.pt"),
                    os.path.join(resumed_dir, "e1.pt"))
    from xpoint_tpu_torch.parallel.mesh import barrier
    barrier(mesh)
    r = Trainer(inp["cfg"], resumed_dir, seed=0, device="cpu",
                dataset=train_ds, val_dataset=val_ds)
    start = r.resume("e1")
    r.train()
    equal = all(torch.equal(x, y) for x, y in zip(_trainer_tensors(r),
                                                  straight))
    flat = torch.cat([x.reshape(-1).float() for x in straight])
    return {"losses": losses, "state": _state(t.state), "start": start,
            "resume_equal": all_reduce(torch.tensor([float(equal)]),
                                       mesh).item() == mesh.size,
            "same_on_every_rank": same_on_every_rank(flat, mesh),
            "files": sorted(os.listdir(os.path.join(root, "port")))}


def train_cases(inp):
    mesh = make_mesh(2)
    return {"dp": {name: dp_steps(case, mesh)
                   for name, case in inp["dp"].items()},
            "resident": resident_batches(inp["resident"], mesh),
            "trainer": trainer_run(inp["trainer"], mesh)}



# ---- a mesh of fewer ranks than the group (tests/test_torch_mesh_subgroup.py)

def subgroup_trainer(inp):
    """``make_mesh(1)`` and ``Trainer(n_devices=1)`` on every rank of the
    group: rank 0 trains as one device would, the others take no step and
    issue no collective (had one, the all-reduce below would not meet)."""
    import torch.distributed as dist
    mesh = make_mesh(1)
    out = {"mesh": (mesh.rank, mesh.size, mesh.member, mesh.group is None)}
    try:
        make_mesh(3)
    except ValueError as e:
        out["make_mesh_3"] = str(e)
    t = Trainer(inp["cfg"], os.path.join(inp["root"], "sub"), n_devices=1,
                seed=0, device="cpu", dataset=FrozenSingleImages(8, seed=1),
                val_dataset=FrozenSingleImages(4, seed=2))
    steps = [0]
    if t.mesh.member:
        inner = t.train_step

        def counted(*a):
            steps[0] += 1
            return inner(*a)
        t.train_step = counted
    state = t.train()
    # every rank's (member, steps, trained state) on WORLD
    facts = torch.zeros(dist.get_world_size(), 3)
    facts[dist.get_rank()] = torch.tensor(
        [float(t.mesh.member), float(steps[0]), float(state is not None)])
    dist.all_reduce(facts)
    out["facts"] = facts
    if t.mesh.member:
        out["tensors"] = _trainer_tensors(t)
        out["files"] = sorted(os.listdir(os.path.join(inp["root"], "sub")))
    return out


def subgroup_collectives():
    """``make_mesh(2)`` in a group of 3: ranks 0 and 1 form a mesh over a
    sub-group (its all-reduce sums theirs alone), rank 2 is outside it."""
    import torch.distributed as dist
    mesh = make_mesh(2)
    out = {}
    if mesh.member:
        out["sum"] = all_reduce(torch.tensor([float(mesh.rank + 1)]),
                                mesh).item()
        out["rows"] = mesh.rows(torch.arange(8)).tolist()
    facts = torch.zeros(dist.get_world_size(), 3)
    facts[dist.get_rank()] = torch.tensor(
        [float(mesh.member), float(mesh.size), float(mesh.rank)])
    dist.all_reduce(facts)
    out["facts"] = facts
    return out
