"""Rank functions for the data-parallel and row-sharding tests
(tests/test_torch_parallel.py, tests/test_torch_spatial.py,
tests/test_torch_spatial_train.py), run by
footprints_tpu_torch.parallel.dryrun.spawn in processes joined over gloo.
Imports no JAX: each returns numpy arrays and floats, which the test holds
against the JAX package in its own process."""

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from footprints_tpu_torch.model_manager import ModelManager
from footprints_tpu_torch.models import FootprintNetwork, Segmentor
from footprints_tpu_torch.models.segmentor import PSP
from footprints_tpu_torch.nn import blocks, layers
from footprints_tpu_torch.ops import fused_conv as fc
from footprints_tpu_torch.parallel import (all_reduce_mean, replica_digest, replicate_tree,
                                           shard_batch, sync_batch_norm)
from footprints_tpu_torch.parallel import halo
from footprints_tpu_torch.parallel.halo import exchange_rows, shard_rows
from footprints_tpu_torch.preprocessing.segmentation import losses as seg_losses
from footprints_tpu_torch.preprocessing.segmentation import trainer as seg_trainer
from footprints_tpu_torch.preprocessing.segmentation.losses import upsample_to
from footprints_tpu_torch.train import step as tstep

SEG_SEED = 10


def _rows(mesh, a):
    per = len(a) // mesh.world_size
    return a[mesh.rank * per:(mesh.rank + 1) * per]


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _image_rows(mesh, a):
    """This rank's image rows (dim 1) of the NHWC ``a`` on a spatial mesh."""
    per = a.shape[1] // mesh.spatial
    return a[:, mesh.row_rank * per:(mesh.row_rank + 1) * per]


def bn_rank(mesh, x, scale, bias, mean, var, cotangent, split=_rows):
    """Global-batch train-mode BN of this rank's shard (``split``: its
    images, or ``_image_rows``) of the NHWC ``x``, then backward of sum(y *
    cotangent): this rank's y and x gradient, the weight and bias gradients
    summed over the ranks, the running stats."""
    xr = _nchw(split(mesh, x)).requires_grad_()
    w = torch.from_numpy(scale).requires_grad_()
    b = torch.from_numpy(bias).requires_grad_()
    rm, rv = torch.from_numpy(mean.copy()), torch.from_numpy(var.copy())
    y = layers.batch_norm(xr, w, b, rm, rv, training=True, group=mesh.group)
    (y * _nchw(split(mesh, cotangent))).sum().backward()
    wb = torch.cat([w.grad, b.grad])
    dist.all_reduce(wb, group=mesh.group)
    return {"y": y.detach().permute(0, 2, 3, 1).numpy(),
            "dx": xr.grad.permute(0, 2, 3, 1).numpy(),
            "dw": wb[:len(scale)].numpy(), "db": wb[len(scale):].numpy(),
            "mean": rm.numpy(), "var": rv.numpy()}


def _step_result(mesh, net, optimizer, metrics):
    """The ranks' mean of each loss term, and from rank 0 the (averaged)
    gradients and the BN running stats; the replica digest from every rank."""
    names = sorted(k for k in metrics if k != "lr")
    losses = all_reduce_mean(mesh, torch.stack([metrics[k] for k in names]))
    out = {"losses": dict(zip(names, losses.tolist())), "lr": metrics["lr"],
           "digest": replica_digest(net, optimizer)}
    if mesh.rank == 0:
        out["grads"] = {n: p.grad.cpu().numpy().copy() for n, p in net.named_parameters()
                        if p.grad is not None}
        out["state_dict"] = {k: v.cpu().numpy().copy() for k, v in net.state_dict().items()}
    return out


def footprint_step_rank(mesh, state_dict_path, batch, global_bn=True):
    """One data-parallel train step of FootprintNetwork-18 (the weights in
    ``state_dict_path``) on this rank's rows of ``batch``; BN over the
    global batch, or over each rank's rows alone (``global_bn=False``, the
    statistics DDP would take by default)."""
    mm = ModelManager(depth=18, steps_per_epoch=5, device="cpu")
    mm.net.load_state_dict(torch.load(state_dict_path), strict=True)
    if global_bn:
        sync_batch_norm(mm.net, mesh)
    replicate_tree(mesh, mm.net)
    step_fn = tstep.build_train_step(mm.net, mm.optimizer, mm.config, mesh)
    metrics = step_fn(0, shard_batch(mesh, batch))
    return _step_result(mesh, mm.net, mm.optimizer, metrics)


def footprint_steps_rank(mesh, state_dict_path, batch):
    """The step with global BN, then with per-rank BN."""
    return {"global": footprint_step_rank(mesh, state_dict_path, batch),
            "per_rank": footprint_step_rank(mesh, state_dict_path, batch, global_bn=False)}


def segmentor_step_rank(mesh, batch):
    """One data-parallel f32 train step of the seeded Segmentor-18 (PSP)."""
    net = Segmentor(18, True, generator=torch.Generator().manual_seed(SEG_SEED))
    sync_batch_norm(net, mesh)
    replicate_tree(mesh, net)
    optimizer = tstep.make_optimizer(net, tstep.TrainStepConfig())
    step_fn = seg_trainer.build_train_step(net, optimizer, lambda s: 1e-4, torch.float32,
                                           mesh)
    metrics = step_fn(0, shard_batch(mesh, batch))
    return _step_result(mesh, net, optimizer, metrics)


def parallel_rank(mesh, state_dict_path, fp_batch, seg_batch, bn_args):
    """Everything test_torch_parallel.py reads from one world: the BN, the
    FootprintNetwork steps and, at world 2, the Segmentor step."""
    out = {"bn": bn_rank(mesh, *bn_args),
           "footprint": footprint_steps_rank(mesh, state_dict_path, fp_batch)}
    if mesh.world_size == 2:
        out["segmentor"] = segmentor_step_rank(mesh, seg_batch)
    return out


def failing_rank(mesh):
    """Rank 1 raises; rank 0 waits for it in a collective that never
    completes."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier(group=mesh.group)


# --- row (spatial) sharding: tests/test_torch_spatial.py ---------------------

def layout_rank(mesh):
    """This rank's place on the spatial mesh and its groups' ranks."""
    return {"rank": mesh.rank, "row_rank": mesh.row_rank, "shard": mesh.shard,
            "spatial": dist.get_process_group_ranks(mesh.spatial_group),
            "data": dist.get_process_group_ranks(mesh.data_group)}


def own_rows(mesh, t, dim=2):
    """This rank's rows (dim ``dim``) of a whole tensor; all of it for no mesh."""
    if mesh is None:
        return t
    per = t.shape[dim] // mesh.spatial
    return t.narrow(dim, mesh.row_rank * per, per)


def _randn(rng, *shape):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32))


def _seeded(module, rng):
    """``module`` with seeded weights of variance 1/fan-in, so activations
    stay of order 1 through its layers."""
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(_randn(rng, *p.shape) / np.sqrt(np.prod(p.shape[1:]) or 1))
    return module


# the op cases' inputs whose rows each rank holds a shard of
ROW_LEAVES = ("image", "x", "low", "skip", "psp_in")


def op_cases(spatial):
    """{name: fn(mesh) -> this rank's rows of the op's NCHW output} for each
    op that reads across rows, on seeded inputs whose rows split into
    ``spatial`` shards; ``fn(None)`` is the unsharded op on the whole input.
    Every rank runs the cases in this order (each is a collective)."""
    return op_setup(spatial)[0]


def op_setup(spatial):
    """``op_cases`` and the leaves they read, {name: tensor}: the inputs
    (ROW_LEAVES, whole) and the weights, every one requiring a gradient."""
    rng = np.random.RandomState(60 + spatial)
    cl = torch.channels_last
    image = _randn(rng, 2, 3, 4 * spatial, 12).contiguous(memory_format=cl)
    x = _randn(rng, 2, 6, 4 * spatial, 10).contiguous(memory_format=cl)
    low = _randn(rng, 2, 6, 3 * spatial, 5).contiguous(memory_format=cl)  # skip: 6 x 10
    skip = _randn(rng, 2, 6, 6 * spatial, 10).contiguous(memory_format=cl)
    psp_in = _randn(rng, 2, 8, 2 * spatial, 6).contiguous(memory_format=cl)
    w7, w3, w1 = _randn(rng, 8, 3, 7, 7), _randn(rng, 6, 6, 3, 3), _randn(rng, 8, 6, 1, 1)
    w_up, w_skip, w2 = _randn(rng, 6, 6, 3, 3), _randn(rng, 6, 6, 3, 3), _randn(rng, 6, 6, 3, 3)
    b = _randn(rng, 6)
    up_block = _seeded(blocks.ConvUpsampleAndConcatBlock(6, 6, 6, fused=True), rng)
    tail = (_seeded(blocks.ConvBlock(6, 4), rng), _seeded(blocks.OutConvBlock(4, 2), rng))
    heads = {s: _seeded(blocks.OutConvBlock(6, 2, s, True), rng) for s in (2, 4, 8)}
    psp = _seeded(PSP(8), rng)
    pre_block = _seeded(blocks.ConvBlock(6, 4, fused=True), rng)
    leaves = {"image": image, "x": x, "low": low, "skip": skip, "psp_in": psp_in, "w7": w7,
              "w3": w3, "w1": w1, "w_up": w_up, "w_skip": w_skip, "w2": w2, "b": b}
    for t in leaves.values():
        t.requires_grad_()
    for prefix, m in (("up_block", up_block), ("tail0", tail[0]), ("tail1", tail[1]),
                      ("psp", psp), *((f"head{s}", h) for s, h in heads.items()),
                      ("pre_block", pre_block)):
        leaves.update({f"{prefix}.{n}": p for n, p in m.named_parameters() if p.requires_grad})

    def nchw(y):
        return y.permute(0, 3, 1, 2)

    def site(mesh, t):
        return blocks._site_input(own_rows(mesh, t), mesh)

    def up_site(mesh):
        lx, halo = site(mesh, low)
        return nchw(fc.up_conv_fused(lx, w_up, b, halo=halo))

    def reflect_site(mesh):
        xx, halo = site(mesh, x)
        return nchw(fc.conv_reflect_fused(xx, w2, b, halo=halo))

    def residual_site(mesh):
        lx, halo = site(mesh, low)
        r = fc.crop_rows(fc.up_conv_fused(lx, w_up, None, act="none"), *halo).contiguous()
        sx, halo = site(mesh, skip)
        return nchw(fc.conv_reflect_res_fused(sx, w_skip, b, r, act="elu", halo=halo))

    def module(mesh, m, *inputs):
        with shard_rows(m, mesh):
            return m(*(own_rows(mesh, t) for t in inputs))

    def tail_fn(mesh):
        with shard_rows(tail[0], mesh), shard_rows(tail[1], mesh):
            return blocks.decoder_tail(*tail, own_rows(mesh, low))

    cases = {
        "stem_conv_7x7_s2": lambda m: layers.conv2d(own_rows(m, image), w7, None, 2, 3, m),
        "max_pool_3x3_s2": lambda m: layers.max_pool_3x3_s2(own_rows(m, x), m),
        "conv_3x3_s1": lambda m: layers.conv2d(own_rows(m, x), w3, None, 1, 1, m),
        "conv_3x3_s2": lambda m: layers.conv2d(own_rows(m, x), w3, None, 2, 1, m),
        "conv_1x1_s2": lambda m: layers.conv2d(own_rows(m, x), w1, None, 2, 0, m),
        "reflect_conv_3x3": lambda m: layers.conv2d(layers.reflect_pad(own_rows(m, x), 1, m),
                                                    w3, b),
        "psp": lambda m: module(m, psp, psp_in),
        "seg_upsample_to_x4": lambda m: nchw(upsample_to(
            own_rows(m, low).permute(0, 2, 3, 1), 4 * own_rows(m, low).shape[2], 20, m)),
        "fused_up2_reflect": up_site,
        "fused_reflect": reflect_site,
        "fused_reflect_residual": residual_site,
        "block4_fused": lambda m: module(m, up_block, low, skip),
        "block3_pre_fused": lambda m: module(m, pre_block, x),
        "decoder_tail": tail_fn,
    }
    for s, head in heads.items():
        cases[f"bilinear_head_x{s}"] = lambda m, head=head: module(m, head, low)
    return cases, leaves


def op_gradients(mesh, spatial):
    """{case: {leaf: gradient}} of sum(output * cotangent) for every op
    case, the cotangent seeded per case over the whole output: on a mesh,
    this rank's rows of each ROW_LEAVES gradient and its whole weight
    gradients (the unsharded op's are their concatenation over the ranks
    and their sum); with ``mesh=None``, the unsharded op's."""
    cases, leaves = op_setup(spatial)
    out = {}
    for i, (name, fn) in enumerate(cases.items()):
        for t in leaves.values():
            t.grad = None
        y = fn(mesh)
        rows = y.shape[2] * (1 if mesh is None else spatial)
        cotangent = _randn(np.random.RandomState(90 + i), y.shape[0], y.shape[1], rows,
                           y.shape[3])
        (y * own_rows(mesh, cotangent)).sum().backward()
        out[name] = {k: (own_rows(mesh, t.grad) if k in ROW_LEAVES else t.grad).numpy().copy()
                     for k, t in leaves.items() if t.grad is not None}
    return out


def ops_rank(mesh):
    """Every op case on this rank's rows (numpy), and the exchanges made."""
    before = exchange_rows.calls
    with torch.no_grad():
        out = {name: fn(mesh).contiguous().numpy() for name, fn in op_cases(mesh.spatial).items()}
    return {"outputs": out, "exchanges": exchange_rows.calls - before}


def _footprint_net(state_dict_path, device="cpu"):
    net = FootprintNetwork(18)
    net.load_state_dict(torch.load(state_dict_path), strict=True)
    return net.to(device)


BF16_HEADS = {"compute_dtype": "bfloat16", "s2d_head": True, "p4_head": True}


def footprint_eval_rank(mesh, state_dict_path, batch):
    """On this rank's shard of ``batch``, on its device: the
    FootprintNetwork-18's spatial eval losses in f32 and in bf16 with the
    packed heads, its rows of the f32 '1/1' map, and the kernel's launches
    in each eval: on the card one a site (models/footprint.py:
    kernel_sites), every site on the rank's rows, 0 on the CPU."""
    net = _footprint_net(state_dict_path, mesh.device)
    local = shard_batch(mesh, batch)
    out = {"shard": {k: v.cpu().numpy() for k, v in local.items()}}
    for name, config in (("f32", tstep.TrainStepConfig()),
                         ("bf16", tstep.TrainStepConfig(**BF16_HEADS))):
        before = fc.fused_conv3x3.launches
        losses = tstep.build_eval_step(net, config, mesh)(local)
        out[name] = {k: float(v) for k, v in losses.items()}
        out[f"{name}_launches"] = fc.fused_conv3x3.launches - before
    with torch.no_grad(), shard_rows(net, mesh):
        out["1/1"] = net(local["image"], scales=("1/1",))["1/1"].cpu().numpy()
    return out


def segmentor_eval_rank(mesh, state_dict_path, batch):
    """The Segmentor-18 (PSP)'s spatial eval losses on this rank's shard."""
    net = Segmentor(18, True)
    net.load_state_dict(torch.load(state_dict_path), strict=True)
    losses = seg_trainer.build_eval_step(net.to(mesh.device), mesh)(shard_batch(mesh, batch))
    return {k: float(v) for k, v in losses.items()}


class _OpShapes(torch.overrides.TorchFunctionMode):
    """Records the input shape of each conv, pool and resize the model code
    calls (not the calls inside them), and whether the PSP was running."""
    OPS = {"conv2d", "max_pool2d", "_max_pool2d", "interpolate", "adaptive_avg_pool2d"}

    def __init__(self):
        super().__init__()
        self.seen, self.in_psp = [], False

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in self.OPS:
            self.seen.append((name, tuple(args[0].shape), self.in_psp))
        return func(*args, **(kwargs or {}))


def op_shapes_rank(mesh, footprint_path, segmentor_path, batch):
    """The (op, input shape, in the PSP) of every conv, pool and resize of
    one row-sharded FootprintNetwork-18 and Segmentor-18 (PSP) forward."""
    local = shard_batch(mesh, batch)["image"]
    seg = Segmentor(18, True)
    seg.load_state_dict(torch.load(segmentor_path), strict=True)
    recorder = _OpShapes()
    seg.decoder.PSP.register_forward_pre_hook(lambda *a: setattr(recorder, "in_psp", True))
    seg.decoder.PSP.register_forward_hook(lambda *a: setattr(recorder, "in_psp", False))
    out = {}
    for name, net in (("footprint", _footprint_net(footprint_path).eval()),
                      ("segmentor", seg.eval())):
        recorder.seen = []
        with torch.no_grad(), shard_rows(net, mesh), recorder:
            net(local)
        out[name] = recorder.seen
    return out


def spatial_rank(mesh, footprint_path, segmentor_path, fp_batch=None, seg_batch=None,
                 ops=False, shapes_batch=None):
    """What test_torch_spatial.py reads from one spatial world: the layout,
    then each part asked for: the FootprintNetwork's and the Segmentor's
    eval steps on their batches, the op cases, the ops' input shapes."""
    out = {"layout": layout_rank(mesh)}
    if fp_batch is not None:
        out["footprint"] = footprint_eval_rank(mesh, footprint_path, fp_batch)
    if seg_batch is not None:
        out["segmentor"] = segmentor_eval_rank(mesh, segmentor_path, seg_batch)
    if ops:
        out["ops"] = ops_rank(mesh)
    if shapes_batch is not None:
        out["shapes"] = op_shapes_rank(mesh, footprint_path, segmentor_path, shapes_batch)
    return out


# --- row-sharded train steps: tests/test_torch_spatial_train.py ---------------

@contextlib.contextmanager
def detached_halos():
    """The halo exchange as it was forward only: its backward passes the
    rank's own rows' gradient through and drops the halo rows'."""
    backward = halo._HaloRows.backward
    halo._HaloRows.backward = staticmethod(lambda ctx, g_top, g_bottom, g_x:
                                           (g_x, None, None, None))
    try:
        yield
    finally:
        halo._HaloRows.backward = backward


class _ForwardOnlySum(torch.autograd.Function):
    """An all-reduce whose backward is the identity (the wrong adjoint)."""

    @staticmethod
    def forward(ctx, t, group):
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        return grad, None


@contextlib.contextmanager
def identity_backward_loss_sum():
    """The seg loss's spatial all-reduce with an identity backward."""
    fn = seg_losses.all_reduce_sum
    seg_losses.all_reduce_sum = _ForwardOnlySum.apply
    try:
        yield
    finally:
        seg_losses.all_reduce_sum = fn


def spatial_step_rank(mesh, model, state_dict_path, batch, config=None):
    """One train step of FootprintNetwork-18 (``config``: a TrainStepConfig's
    keywords) or Segmentor-18 (PSP; ``config``: {'compute_dtype': ...}) from
    the weights in ``state_dict_path``, on this rank's shard of ``batch`` on
    its device: ``_step_result``, this rank's forward and backward
    exchanges and the kernel's forward launches: on the card one a site of
    the model (models/footprint.py: kernel_sites), 0 on the CPU."""
    config = config or {}
    if model == "footprint":
        net = _footprint_net(state_dict_path, mesh.device)
        train_config = tstep.TrainStepConfig(steps_per_epoch=5, **config)
        optimizer = tstep.make_optimizer(net, train_config)
        step_fn = tstep.build_train_step(net, optimizer, train_config, mesh)
    else:
        net = Segmentor(18, True)
        net.load_state_dict(torch.load(state_dict_path), strict=True)
        net.to(mesh.device)
        optimizer = tstep.make_optimizer(net, tstep.TrainStepConfig())
        step_fn = seg_trainer.build_train_step(
            net, optimizer, lambda s: 1e-4,
            tstep.resolve_compute_dtype(config.get("compute_dtype")), mesh)
    sync_batch_norm(net, mesh)
    replicate_tree(mesh, net)
    before = exchange_rows.calls, exchange_rows.backward_calls, fc.fused_conv3x3.launches
    metrics = step_fn(0, shard_batch(mesh, batch))
    return {**_step_result(mesh, net, optimizer, metrics),
            "exchanges": [exchange_rows.calls - before[0],
                          exchange_rows.backward_calls - before[1]],
            "launches": fc.fused_conv3x3.launches - before[2]}


def mismatched_backward_rank(mesh):
    """Two exchanges of equal shapes whose backwards the ranks run in
    opposite orders: the error each rank raises, or None."""
    a, b = (torch.randn(1, 2, 4, 3, requires_grad=True) for _ in range(2))
    ya, yb = exchange_rows(a, 1, 1, mesh), exchange_rows(b, 1, 1, mesh)
    first, second = (ya, yb) if mesh.rank == 0 else (yb, ya)
    try:
        first.sum().backward()
        second.sum().backward()
    except RuntimeError as e:
        return str(e)
    return None


def spatial_train_rank(mesh, footprint_path, segmentor_path, fp_batch, seg_batch,
                       spatial_ops=None, bn_args=None, extra=False):
    """What test_torch_spatial_train.py reads from one spatial world: the
    f32 train steps of both models; the op cases' gradients at
    ``spatial_ops`` row shards; the row-sharded BN; and with ``extra`` the
    bf16 steps, the negative controls and the mismatched backward."""
    out = {"footprint": spatial_step_rank(mesh, "footprint", footprint_path, fp_batch),
           "segmentor": spatial_step_rank(mesh, "segmentor", segmentor_path, seg_batch)}
    if spatial_ops is not None:
        out["ops"] = op_gradients(mesh, spatial_ops)
    if bn_args is not None:
        out["bn"] = bn_rank(mesh, *bn_args, split=_image_rows)
    if extra:
        out["footprint_bf16"] = spatial_step_rank(mesh, "footprint", footprint_path, fp_batch,
                                                  BF16_HEADS)
        out["segmentor_bf16"] = spatial_step_rank(mesh, "segmentor", segmentor_path, seg_batch,
                                                  {"compute_dtype": "bfloat16"})
        with detached_halos():
            out["footprint_detached"] = spatial_step_rank(mesh, "footprint", footprint_path,
                                                          fp_batch)
        with identity_backward_loss_sum():
            out["segmentor_identity"] = spatial_step_rank(mesh, "segmentor", segmentor_path,
                                                          seg_batch)
        out["mismatch"] = mismatched_backward_rank(mesh)
    return out


def ops_grad_rank(mesh, footprint_path, fp_batch):
    """The op cases' gradients on this rank's rows, and the
    FootprintNetwork-18's f32 train step."""
    return {"ops": op_gradients(mesh, mesh.spatial),
            "footprint": spatial_step_rank(mesh, "footprint", footprint_path, fp_batch)}
