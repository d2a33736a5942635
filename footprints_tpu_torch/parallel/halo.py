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
nothing falls back to gathering the whole image.  Forward only: the
adjoint, and so row-sharded training, is not ported yet.

``shard_rows(module, mesh)`` marks every submodule of a network for the
span of a forward, as ``sync_batch_norm`` hands BN its group; a layer reads
the mark with ``row_mesh``, and without one runs exactly its unsharded code.
"""

import contextlib

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


def _all_gather(x, mesh):
    """Every rank's NCHW ``x`` (equal shapes) over the spatial group, in
    row order, as NCHW views of NHWC memory.  Sent as one flat buffer of
    bytes, which every backend moves whatever the dtype (gloo has no bf16
    gather)."""
    nhwc = x.permute(0, 2, 3, 1).contiguous()
    flat = nhwc.view(-1).view(torch.uint8)
    parts = [torch.empty_like(flat) for _ in range(mesh.spatial)]
    dist.all_gather(parts, flat, group=mesh.spatial_group)
    return [p.view(nhwc.dtype).view(nhwc.shape).permute(0, 3, 1, 2) for p in parts]


def halo_rows(x, above, below, mesh):
    """The neighbour rows of this rank's NCHW row shard ``x``: (the last
    ``above`` rows of the rank above, the first ``below`` rows of the rank
    below), None where there is no such rank (``seam_rows``).  A
    collective of the spatial group: every rank calls it with the same
    halo."""
    h = x.shape[2]
    if above == below == 0:
        return None, None
    if max(above, below) > h:
        raise ValueError(f"a halo of {above}/{below} rows needs at least that many rows "
                         f"a shard, got {h}")
    with torch.profiler.record_function("exchange_rows"):
        # each rank's first `below` rows (the halo of the rank above) and
        # last `above` rows (the halo of the rank below)
        strips = _all_gather(torch.cat([x[:, :, :below], x[:, :, h - above:]], 2), mesh)
    exchange_rows.calls += 1
    a, b = seam_rows(mesh, above, below)
    j = mesh.row_rank
    return (strips[j - 1][:, :, below:] if a else None,
            strips[j + 1][:, :, :below] if b else None)


def exchange_rows(x, above, below, mesh):
    """This rank's NCHW row shard ``x`` with ``above`` rows of the rank
    above before it and ``below`` rows of the rank below after it, where
    those ranks exist (``halo_rows``)."""
    top, bottom = halo_rows(x, above, below, mesh)
    parts = [t for t in (top, x, bottom) if t is not None]
    return torch.cat(parts, 2) if len(parts) > 1 else x


exchange_rows.calls = 0  # exchanges made in this process (gather_rows' included)


def gather_rows(x, mesh):
    """The whole map of which ``x`` is this rank's row shard (NCHW)."""
    with torch.profiler.record_function("gather_rows"):
        parts = _all_gather(x, mesh)
    exchange_rows.calls += 1
    return torch.cat(parts, 2)


def own_rows(x, rows, mesh):
    """This rank's ``rows`` rows of a whole NCHW map."""
    return x[:, :, mesh.row_rank * rows:(mesh.row_rank + 1) * rows]
