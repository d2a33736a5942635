"""Row sharding of an activation over a spatial mesh: the halo exchange
(counterpart of the halos that XLA's spatial partitioner inserts for the
JAX package's ``batch_sharded`` images, footprints_tpu/parallel/mesh.py).

On a spatial mesh (parallel/mesh.py:make_mesh(spatial=k)) rank ``r`` holds
rows ``[r0, r0 + h)`` of every activation, ``r0`` a multiple of its level's
share of the encoder's stride, so every level's shards tile the global
grid.  An op that reads across rows computes on ``[halo above; own rows;
halo below]`` and keeps its own rows of the output:

  * ``exchange_rows`` adds the neighbours' rows at a seam and nothing at
    the image's true top or bottom edge, where the op applies its own
    padding (zero, -inf, reflect, or a clamp) as it does unsharded
    (nn/layers.py, nn/blocks.py, ops/fused_conv.py); ``halo_rows`` gives
    those rows apart, for a caller that writes them into its own buffer;
  * ``gather_rows`` assembles a whole map (the PSP's 1/32 map, whose
    adaptive pools span the shards; models/segmentor.py).

Both are one ``all_gather`` over the rank's spatial group: every rank sends
the strips its neighbours need, so the same code runs over gloo (several
ranks on one card, or the CPU) and NCCL.  A failed collective raises;
nothing falls back to gathering the whole image.

Both are differentiable, so a train step runs row-sharded too.  The
adjoint of a halo exchange sends each halo row's cotangent back to the rank
that owns the row, which adds it to its own rows' gradient; the adjoint of
``gather_rows`` sums every rank's cotangent of the whole map and keeps the
rank's own rows.  Each adjoint is again one ``all_gather`` of the spatial
group, so every rank must reach the exchanges' backwards in one order
(autograd runs them in the reverse of the order the forward made them, on
every rank).  Each exchange takes a sequence number in its forward and
sends it with its cotangents; a backward whose ranks sent different
numbers raises, and never adds a strip of another exchange (a strip of
another size fails the collective itself).

``shard_rows(module, mesh)`` marks every submodule of a network for the
span of a forward, as ``sync_batch_norm`` hands BN its group; a layer reads
the mark with ``row_mesh``, and without one runs exactly its unsharded code.
"""

import contextlib
import itertools

import torch
import torch.distributed as dist


def spatial_mesh(mesh):
    """``mesh`` if it shards rows (``spatial > 1``), else None."""
    return mesh if mesh is not None and mesh.spatial > 1 else None


@contextlib.contextmanager
def shard_rows(module, mesh):
    """Within the block, ``module``'s layers compute on this rank's row
    shard of every activation; a no-op off a spatial mesh."""
    mesh = spatial_mesh(mesh)
    if mesh is None:
        yield module
        return
    modules = list(module.modules())
    for m in modules:
        m.row_mesh = mesh
    try:
        yield module
    finally:
        for m in modules:
            del m.row_mesh


def row_mesh(module):
    """The spatial mesh that ``shard_rows`` set on ``module``, or None (a
    plain dict lookup: no ``nn.Module.__getattr__`` miss on the unsharded
    path)."""
    return module.__dict__.get("row_mesh")


def seam_rows(mesh, above, below):
    """Of ``above`` and ``below`` halo rows, those that a neighbour gives
    this rank (a seam); the rest lie beyond the image's edge."""
    last = mesh.spatial - 1
    return (above if mesh.row_rank > 0 else 0), (below if mesh.row_rank < last else 0)


def edge_rows(mesh, above, below):
    """Of ``above`` and ``below`` halo rows, those beyond the image's edge,
    which the op pads itself."""
    a, b = seam_rows(mesh, above, below)
    return above - a, below - b


def _all_gather(x, mesh, tag=None):
    """Every rank's NCHW ``x`` (equal shapes) over the spatial group, in
    row order, as NCHW views of NHWC memory.  Sent as one flat buffer of
    bytes, which every backend moves whatever the dtype (gloo has no bf16
    gather).  ``tag`` (an exchange's sequence number, for a backward) goes
    in front of the bytes; it raises unless every rank sent the same."""
    nhwc = x.permute(0, 2, 3, 1).contiguous()
    flat = nhwc.view(-1).view(torch.uint8)
    if tag is not None:
        head = torch.tensor([tag], dtype=torch.int64, device=x.device).view(torch.uint8)
        flat = torch.cat([head, flat])
    parts = [torch.empty_like(flat) for _ in range(mesh.spatial)]
    dist.all_gather(parts, flat, group=mesh.spatial_group)
    if tag is not None:
        tags = torch.stack([p[:8] for p in parts]).view(torch.int64).view(-1).tolist()
        if len(set(tags)) != 1:
            raise RuntimeError(f"the ranks of the spatial group are in the backwards of "
                               f"different exchanges (sequence numbers {tags}, rank "
                               f"{mesh.rank} at {tag}): the backward order differs "
                               f"between ranks")
        parts = [p[8:] for p in parts]
    return [p.view(nhwc.dtype).view(nhwc.shape).permute(0, 3, 1, 2) for p in parts]


_SEQUENCE = itertools.count()  # numbers the exchanges made in this process


class _HaloRows(torch.autograd.Function):
    """(top, bottom, x) of ``halo_rows``; its backward adds the cotangents
    of the rank above's ``bottom`` and the rank below's ``top`` to the rows
    of x they were copied from.  x comes back through the Function, so that
    its backward runs on every rank of the group (at the image's edge a
    rank may have no seam, yet it owes its neighbour the exchange)."""

    @staticmethod
    def forward(ctx, x, above, below, mesh):
        h, j = x.shape[2], mesh.row_rank
        with torch.profiler.record_function("exchange_rows"):
            # each rank's first `below` rows (the halo of the rank above) and
            # last `above` rows (the halo of the rank below)
            strips = _all_gather(torch.cat([x[:, :, :below], x[:, :, h - above:]], 2), mesh)
        exchange_rows.calls += 1
        a, b = seam_rows(mesh, above, below)
        ctx.above, ctx.below, ctx.mesh, ctx.tag = above, below, mesh, next(_SEQUENCE)
        return (strips[j - 1][:, :, below:] if a else x[:, :, :0],
                strips[j + 1][:, :, :below] if b else x[:, :, :0], x)

    @staticmethod
    def backward(ctx, g_top, g_bottom, g_x):
        above, below, mesh = ctx.above, ctx.below, ctx.mesh
        (n, c, h, w), j = g_x.shape, mesh.row_rank
        # [cotangent of top; of bottom], zeros where this rank has no seam
        send = torch.cat([g_top if g_top.shape[2] else g_x.new_zeros((n, c, above, w)),
                          g_bottom if g_bottom.shape[2] else g_x.new_zeros((n, c, below, w))],
                         2)
        with torch.profiler.record_function("exchange_rows.backward"):
            strips = _all_gather(send, mesh, ctx.tag)
        exchange_rows.backward_calls += 1
        gx = g_x.clone()
        if above and j < mesh.spatial - 1:  # the rank below's top: our last rows
            gx[:, :, h - above:] += strips[j + 1][:, :, :above]
        if below and j > 0:  # the rank above's bottom: our first rows
            gx[:, :, :below] += strips[j - 1][:, :, above:]
        return gx, None, None, None


def halo_rows(x, above, below, mesh):
    """The neighbour rows of this rank's NCHW row shard ``x``: (the last
    ``above`` rows of the rank above, the first ``below`` rows of the rank
    below, ``x``), None where there is no such rank (``seam_rows``).  The
    caller computes on the ``x`` returned here, through which the
    exchange's backward runs.  A collective of the spatial group: every
    rank calls it with the same halo."""
    h = x.shape[2]
    if above == below == 0:
        return None, None, x
    if max(above, below) > h:
        raise ValueError(f"a halo of {above}/{below} rows needs at least that many rows "
                         f"a shard, got {h}")
    top, bottom, x = _HaloRows.apply(x, above, below, mesh)
    return (top if top.shape[2] else None), (bottom if bottom.shape[2] else None), x


def exchange_rows(x, above, below, mesh):
    """This rank's NCHW row shard ``x`` with ``above`` rows of the rank
    above before it and ``below`` rows of the rank below after it, where
    those ranks exist (``halo_rows``)."""
    top, bottom, x = halo_rows(x, above, below, mesh)
    parts = [t for t in (top, x, bottom) if t is not None]
    return torch.cat(parts, 2) if len(parts) > 1 else x


# exchanges made in this process (gather_rows' included), and their backwards
exchange_rows.calls = 0
exchange_rows.backward_calls = 0


class _GatherRows(torch.autograd.Function):
    """``gather_rows``; its backward sums every rank's cotangent of the
    whole map (in f32, in rank order) and keeps this rank's rows: a
    reduce-scatter, as one all-gather of the cotangents."""

    @staticmethod
    def forward(ctx, x, mesh):
        with torch.profiler.record_function("gather_rows"):
            parts = _all_gather(x, mesh)
        exchange_rows.calls += 1
        ctx.mesh, ctx.rows, ctx.tag = mesh, x.shape[2], next(_SEQUENCE)
        return torch.cat(parts, 2)

    @staticmethod
    def backward(ctx, g):
        mesh, rows = ctx.mesh, ctx.rows
        with torch.profiler.record_function("gather_rows.backward"):
            parts = _all_gather(g, mesh, ctx.tag)
        exchange_rows.backward_calls += 1
        total = parts[0].float()
        for p in parts[1:]:
            total = total + p.float()
        j = mesh.row_rank
        return total[:, :, j * rows:(j + 1) * rows].to(g.dtype), None


def gather_rows(x, mesh):
    """The whole map of which ``x`` is this rank's row shard (NCHW)."""
    return _GatherRows.apply(x, mesh)


def own_rows(x, rows, mesh):
    """This rank's ``rows`` rows of a whole NCHW map."""
    return x[:, :, mesh.row_rank * rows:(mesh.row_rank + 1) * rows]
