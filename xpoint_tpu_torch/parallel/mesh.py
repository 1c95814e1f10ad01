"""Data-parallel mesh over ``torch.distributed`` ranks (port of
``xpoint_tpu/parallel/mesh.py``).

The JAX package shards the batch over a 1-D device mesh inside one
single-controller program; GSPMD then makes gradients and BatchNorm
statistics global. Here a mesh is one process per rank, each with one
device, joined by a process group (``parallel.launch`` starts them). A
sharded step keeps the JAX meaning: n ranks compute, per sample and for the
step as a whole, what one device computes on the global batch. The
collectives that make that so live in this module:

  * :func:`all_reduce` sums over the ranks, differentiably: its backward
    sums the cotangents over the ranks too (the adjoint of a sum that every
    rank reads), so a rank's gradient holds its samples' share of every
    cross-rank path (global BatchNorm statistics, the ring scan's state);
  * :func:`all_gather` stacks one tensor of each rank, (n, ...), as an
    all-reduce of a zero-filled buffer whose row r rank r fills: sums with
    zeros are exact, so the gather is bit for bit;
  * :func:`broadcast` copies rank 0's tensors into every rank's.

Only ``all_reduce`` and ``broadcast`` are used: with ``barrier`` they are
the collectives ``gloo`` offers on CUDA tensors as well as on CPU ones, so
the same code runs on ``gloo`` on the CPU (tests), ``gloo`` with two ranks
on one card, and ``nccl``. ``collectives`` counts every call.

:func:`data_parallel` makes a mesh the active one while a train step runs:
BatchNorm then normalises with the global batch's statistics, and the
batch-shaped draws (DropPath, Dropout, the loss's tiebreak) draw the global
batch's numbers from the step's generator and keep this rank's rows
(:func:`rand_rows`), so each rank's masks are the single-device masks'
rows.
"""
import contextlib

import torch
import torch.distributed as dist

_ACTIVE = None          # the mesh of the running data-parallel step
_RANK_DEVICES = None    # the launcher's device list, one per rank


class Mesh:
    """A 1-D data-parallel mesh as one rank sees it: ``rank``, ``size``
    (the number of ranks), this rank's ``device`` and the process
    ``group`` (None for a one-rank mesh). ``member`` is False on a rank of
    the process group that a mesh of its first ``size`` ranks leaves out:
    such a rank takes no part in the mesh's work (its ``rank`` is its rank
    in the process group)."""

    def __init__(self, rank, size, device, group=None, member=True):
        self.rank, self.size = int(rank), int(size)
        self.device = torch.device(device)
        self.group = group
        self.member = bool(member)

    def rows(self, x):
        """This rank's rows of a tensor whose leading axis is the global
        batch (size * B rows -> B)."""
        if self.size == 1:
            return x
        n = x.shape[0]
        if n % self.size:
            raise ValueError(f"a batch of {n} does not split over "
                             f"{self.size} ranks")
        b = n // self.size
        return x[self.rank * b:(self.rank + 1) * b]


def _set_rank_devices(devices):
    global _RANK_DEVICES
    _RANK_DEVICES = list(devices)


def make_mesh(n_devices=None, devices=None, device="cuda"):
    """The mesh over the first ``n_devices`` ranks of the process group
    (default: every rank; one rank and no group when none is initialised),
    as JAX's ``make_mesh`` takes the first n devices.

    With fewer ranks than the group has, every rank of the group must call
    this (it builds the sub-group of ranks 0..n-1 with ``dist.new_group``);
    the ranks past n get a mesh with ``member`` False, and take no part.
    ``devices`` names each rank's device (a list as long as the group);
    default: the list the launcher was given, else ``cuda:<rank>`` (or
    ``device`` for a one-rank group). Raises, as JAX's does when fewer
    devices exist, if ``n_devices`` asks for more ranks than the group
    has; and if ``devices`` does not name one device a rank, or if the
    default CUDA devices do not exist: silently truncating would let a
    "multi-device" check pass on one."""
    grouped = dist.is_available() and dist.is_initialized()
    rank, world = ((dist.get_rank(), dist.get_world_size()) if grouped
                   else (0, 1))
    size = world if n_devices is None else int(n_devices)
    if size > world:
        raise ValueError(
            f"make_mesh: asked for {size} devices but the process group "
            f"has only {world} rank(s); start one rank a device with "
            f"xpoint_tpu_torch.parallel.launch")
    if size < 1:
        raise ValueError(f"make_mesh: asked for {size} devices")
    if devices is None:
        devices = _RANK_DEVICES
    if devices is None:
        dev = torch.device(device)
        if world == 1:
            devices = [dev]
        elif dev.type == "cuda":
            devices = [torch.device("cuda", r) for r in range(world)]
        else:
            devices = [dev] * world
    devices = [torch.device(d) for d in devices]
    if len(devices) != world:
        raise ValueError(f"make_mesh: {len(devices)} devices named for "
                         f"{world} rank(s)")
    mine = devices[rank]
    if mine.type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if (mine.index or 0) >= have:
            raise ValueError(
                f"make_mesh: rank {rank} asks for {mine} but only {have} "
                f"CUDA device(s) exist")
    if size == world:
        group = dist.group.WORLD if grouped else None
    else:
        # a collective call: every rank of the group takes part in it
        group = dist.new_group(list(range(size))) if size > 1 else None
        if rank >= size:
            return Mesh(rank, size, mine, None, member=False)
    return Mesh(rank, size, mine, group)


def shard_batch(batch, mesh):
    """This rank's slice of a global batch: every tensor or array of the
    (nested) dict keeps its rows of the leading axis."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    if hasattr(batch, "shape") and len(batch.shape):
        return mesh.rows(batch)
    return batch


def replicate(tree, mesh):
    """Rank 0's tensors in every rank: each tensor of a (nested) dict or
    list, or of a module's parameters and buffers, broadcast in place.
    Returns ``tree``."""
    broadcast(list(tree.parameters()) + list(tree.buffers())
              if isinstance(tree, torch.nn.Module) else list(_leaves(tree)),
              mesh)
    return tree


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif torch.is_tensor(tree):
        yield tree


class _Counter:
    count = 0


# every collective this process issues adds one to ``collectives.count``
collectives = _Counter()


def _count():
    collectives.count += 1


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        _count()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _count()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce(x, mesh):
    """The sum over the ranks of ``x`` (every rank gets it), differentiable
    (see the module docstring); ``x`` itself is left as it is. On a
    one-rank mesh, ``x``."""
    if mesh.size == 1:
        return x
    if not x.requires_grad:
        y = x.clone()
        _count()
        dist.all_reduce(y, group=mesh.group)
        return y
    return _AllReduce.apply(x, mesh.group)


def all_gather(x, mesh):
    """(size, *x.shape): row r is rank r's ``x``, on every rank, bit for
    bit; differentiable. bool tensors travel as uint8."""
    if x.dtype == torch.bool:
        return all_gather(x.to(torch.uint8), mesh).bool()
    rows = [torch.zeros_like(x)[None]] * mesh.size
    rows[mesh.rank] = x[None]
    return all_reduce(torch.cat(rows), mesh)


def gather_rows(x, mesh):
    """The global batch from each rank's rows: ``all_gather`` flattened
    over the rank axis, (size * B, ...)."""
    if mesh.size == 1:
        return x
    return all_gather(x, mesh).flatten(0, 1)


def broadcast(tensors, mesh, src=0):
    """Copy rank ``src``'s tensors into the others', in place."""
    if mesh.size == 1:
        return
    with torch.no_grad():
        for t in tensors:
            _count()
            dist.broadcast(t.data, src, group=mesh.group)


@contextlib.contextmanager
def data_parallel(mesh):
    """Make ``mesh`` the active data-parallel mesh (``active_mesh``) for
    the block: global BatchNorm statistics and global-batch draws."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = mesh if mesh is not None and mesh.size > 1 else None
    try:
        yield
    finally:
        _ACTIVE = prev


def active_mesh():
    """The mesh of the running data-parallel step, or None."""
    return _ACTIVE


def rand_rows(shape, generator, device):
    """``torch.rand(shape)`` for a tensor whose leading axis is the batch:
    under an active mesh of n ranks, the (n * shape[0], ...) numbers of the
    global batch are drawn and this rank's rows kept, so every rank
    advances the generator as one device would and holds its rows of the
    single-device draw."""
    mesh = _ACTIVE
    if mesh is None:
        return torch.rand(shape, generator=generator, device=device)
    full = (shape[0] * mesh.size,) + tuple(shape[1:])
    return mesh.rows(torch.rand(full, generator=generator, device=device))


def batch_moments(x, dims):
    """The fp32 mean and mean square over ``dims`` of ``x``, over the
    global batch under the active mesh (one all-reduce of the two sums).
    Returns (mean, mean_sq)."""
    mesh = _ACTIVE
    if mesh is None:
        return x.mean(dims), (x * x).mean(dims)
    count = 1
    for d in dims:
        count *= x.shape[d]
    s = torch.stack([x.sum(dims), (x * x).sum(dims)])
    s = all_reduce(s, mesh)
    n = count * mesh.size
    return s[0] / n, s[1] / n


def global_mean(x, dims):
    """``x.mean(dims)`` over the global batch under the active mesh
    (differentiable)."""
    mesh = _ACTIVE
    if mesh is None:
        return x.mean(dims)
    count = 1
    for d in dims:
        count *= x.shape[d]
    return all_reduce(x.sum(dims), mesh) / (count * mesh.size)


def barrier(mesh):
    """Wait until every rank reaches this point (a checkpoint written by
    rank 0 before the others read it)."""
    if mesh.size > 1:
        _count()
        dist.barrier(group=mesh.group)


def mean_over_ranks(x, mesh):
    """The mean over the ranks of ``x`` (one all-reduce)."""
    if mesh is None or mesh.size == 1:
        return x
    return all_reduce(x, mesh) / mesh.size
