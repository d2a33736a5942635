"""Row (spatial) sharding of the port's eval steps
(footprints_tpu_torch/parallel/{mesh,halo}.py) held against the JAX
package's spatial mesh on the CPU.

Worlds of 2 to 4 ranks run in processes joined over gloo
(tests/_torch_dp_worker.py, no JAX there), each on
``make_mesh(spatial=k)``; named by their (data x spatial) layout.  The JAX
references are one compile per model and mesh on the virtual CPU devices
of tests/conftest.py: ``build_eval_step(..., mesh=make_mesh(devices,
spatial=k))`` for the FootprintNetwork, and for the Segmentor a ``jax.jit``
with the shardings of the JAX seg trainer's ``_build_eval_step``.

Tolerances: each halo'd op, gathered over the ranks, within 1e-6 of the
unsharded op on the same inputs (the same arithmetic on other tensor sizes;
measured 0 at most ops, 3.6e-7 at the fused decoder block); eval losses
within 1e-5 of the JAX spatial eval step (tests/test_spatial_sharding.py's
bar; measured 6e-7), the gathered '1/1' map within MAE 1e-4 of the JAX
single-device forward (tests/test_parity_full_res.py's; measured 8e-9);
the bf16 eval with the packed heads no farther from the f32 eval than
twice the port's unsharded bf16 eval is, plus 1e-3 (the bf16 rule of
tests/test_torch_bf16_train.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from footprints_tpu.models import Segmentor as JaxSegmentor
from footprints_tpu.parallel import make_mesh as jax_make_mesh
from footprints_tpu.parallel import shard_batch as jax_shard_batch
from footprints_tpu.parallel.mesh import batch_sharded, replicated
from footprints_tpu.preprocessing.segmentation.losses import compute_seg_losses as jax_seg_losses
from footprints_tpu.train import step as jstep
from footprints_tpu_torch import parallel
from footprints_tpu_torch.convert import (segmentor_jax_params_from_state_dict,
                                          segmentor_state_dict_from_jax_params)
from footprints_tpu_torch.models import Segmentor
from footprints_tpu_torch.parallel.dryrun import spawn
from footprints_tpu_torch.preprocessing.segmentation.losses import upsample_to
from footprints_tpu_torch.train import step as tstep
from footprints_tpu_torch.train.losses import bce_with_logits

from . import _torch_dp_worker as worker
from ._torch_port import _randomise_bn, jax_model
from .test_torch_train_step import _targets

# (world, spatial) of each world, named data x spatial
WORLDS = {"2x2": (4, 2), "1x4": (4, 4), "1x2": (2, 2), "1x3": (3, 3)}
# the FootprintNetwork-18's (batch, H, W) in each world that runs it
FP_SHAPES = {"2x2": (4, 64, 96), "1x4": (2, 128, 64)}
SEG_WORLDS = ("1x2", "2x2")
SEG_SHAPE = (4, 64, 96)
# the op shapes' forward: tall enough that every level's own rows plus
# the largest halo stay below the whole level (H / 32 = 16 rows, 8 a rank)
SHAPES_HW = (512, 96)
OP_WORLDS = {2: "1x2", 3: "1x3"}
OPS = ("stem_conv_7x7_s2", "max_pool_3x3_s2", "conv_3x3_s1", "conv_3x3_s2", "conv_1x1_s2",
       "reflect_conv_3x3", "psp", "seg_upsample_to_x4", "fused_up2_reflect", "fused_reflect",
       "fused_reflect_residual", "block4_fused", "block3_pre_fused", "decoder_tail",
       "bilinear_head_x2", "bilinear_head_x4", "bilinear_head_x8")


def _fp_batch(n, h, w, seed):
    rng = np.random.RandomState(seed)
    return {"image": rng.rand(n, h, w, 3).astype(np.float32), **_targets(n, h, w, seed + 1)}


def _seg_batch():
    """Image 0's labelled pixels all lie in its first 16 rows, inside one
    row shard: normalising per shard instead of per image shows there."""
    n, h, w = SEG_SHAPE
    rng = np.random.RandomState(71)
    labelled = (rng.rand(n, h, w) > 0.2).astype(np.float32)
    labelled[0, 16:] = 0.0
    return {"image": rng.rand(n, h, w, 3).astype(np.float32),
            "ground_mask": (rng.rand(n, h, w) > 0.5).astype(np.float32),
            "labelled_pix": labelled}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The FootprintNetwork-18 and Segmentor-18 (PSP) weights with
    randomised BN: JAX pytrees, and the port's state_dicts as files."""
    root = tmp_path_factory.mktemp("spatial")
    jnet, params, state, net = jax_model(18, seed=5)
    torch.save(net.state_dict(), root / "footprint.pt")
    sd = Segmentor(18, True, generator=torch.Generator().manual_seed(3)).state_dict()
    sparams, sstate = segmentor_jax_params_from_state_dict(sd, 18, True)
    rng = np.random.RandomState(3)
    sparams, sstate = _randomise_bn(sparams, rng), _randomise_bn(sstate, rng)
    torch.save(segmentor_state_dict_from_jax_params(sparams, sstate, 18, True),
               root / "segmentor.pt")
    return {"footprint": (jnet, params, state, str(root / "footprint.pt")),
            "segmentor": (sparams, sstate, str(root / "segmentor.pt"))}


@pytest.fixture(scope="module")
def worlds(weights):
    """{world name: the ranks' results}: one spawn per world."""
    paths = (weights["footprint"][3], weights["segmentor"][2])
    parts = {"2x2": {"fp_batch": _fp_batch(*FP_SHAPES["2x2"], 80), "seg_batch": _seg_batch()},
             "1x4": {"fp_batch": _fp_batch(*FP_SHAPES["1x4"], 82)},
             "1x2": {"seg_batch": _seg_batch(), "ops": True,
                     "shapes_batch": {"image": np.random.RandomState(84).rand(
                         1, *SHAPES_HW, 3).astype(np.float32)}},
             "1x3": {"ops": True}}
    keys = ("fp_batch", "seg_batch", "ops", "shapes_batch")
    return {name: spawn(world, worker.spatial_rank, *paths,
                        *(parts[name].get(k) for k in keys), device="cpu", spatial=spatial,
                        timeout=600)
            for name, (world, spatial) in WORLDS.items()}


def _jax_mesh(name):
    world, spatial = WORLDS[name]
    return jax_make_mesh(jax.devices()[:world], spatial=spatial)


def _gather(ranks, spatial, get, axis):
    """The whole batch from the ranks' shards: rows (``axis``) within each
    data index, then the data indices along the batch."""
    shards = [get(r) for r in ranks]
    return np.concatenate([np.concatenate(shards[i:i + spatial], axis)
                           for i in range(0, len(shards), spatial)], 0)


# --- the mesh --------------------------------------------------------------

@pytest.mark.parametrize("name", list(WORLDS))
def test_rank_layout_matches_jax(worlds, name):
    world, spatial = WORLDS[name]
    layout = np.arange(world).reshape(world // spatial, spatial)
    devices = jax.devices()[:world]
    jax_layout = np.vectorize(devices.index)(_jax_mesh(name).devices)
    np.testing.assert_array_equal(jax_layout, layout)
    assert _jax_mesh(name).axis_names == (parallel.DATA_AXIS, parallel.SPATIAL_AXIS)
    for r, result in enumerate(worlds[name]):
        got = result["layout"]
        i, j = np.argwhere(layout == r)[0]
        assert got["rank"] == r and got["row_rank"] == j
        assert tuple(got["shard"]) == (i, world // spatial)
        assert got["spatial"] == layout[i].tolist()
        assert got["data"] == layout[:, j].tolist()


@pytest.mark.parametrize("name", list(FP_SHAPES))
def test_shard_batch_matches_jax_addressable_shards(worlds, name):
    world, _ = WORLDS[name]
    batch = _fp_batch(*FP_SHAPES[name], 80 if name == "2x2" else 82)
    devices = jax.devices()[:world]
    placed = jax_shard_batch(_jax_mesh(name), batch)
    for key, arr in placed.items():
        for shard in arr.addressable_shards:
            got = worlds[name][devices.index(shard.device)]["footprint"]["shard"][key]
            np.testing.assert_array_equal(got, np.asarray(shard.data), err_msg=key)


def test_make_mesh_refuses_a_spatial_size_that_does_not_divide_the_world():
    with pytest.raises(AssertionError, match="4 devices not divisible by spatial=3"):
        jax_make_mesh(jax.devices()[:4], spatial=3)
    with pytest.raises(ValueError, match="1 devices not divisible by spatial=2"):
        parallel.make_mesh("cpu", spatial=2)


@pytest.mark.parametrize("spatial,height", [(2, 96), (3, 64), (4, 64), (2, 48)])
def test_row_split_refuses_rows_off_the_encoder_stride(spatial, height):
    mesh = parallel.Mesh(spatial, 0, torch.device("cpu"), spatial=spatial)
    with pytest.raises(ValueError, match=f"multiple of 32 x spatial = {32 * spatial}"):
        parallel.shard_batch(mesh, {"image": np.zeros((1, height, 8, 3), np.float32)})
    assert parallel.row_split(mesh, 32 * spatial * 3) == (0, 32 * 3)


# --- the halo'd ops ---------------------------------------------------------------

def test_op_cases_are_the_listed_ops():
    assert tuple(worker.op_cases(2)) == OPS


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("spatial", list(OP_WORLDS))
def test_halo_op_matches_the_unsharded_op(worlds, spatial, op):
    ranks = worlds[OP_WORLDS[spatial]]
    with torch.no_grad():
        ref = worker.op_cases(spatial)[op](None).numpy()
    got = np.concatenate([r["ops"]["outputs"][op] for r in ranks], 2)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("model", ["footprint", "segmentor"])
def test_no_rank_computes_on_more_than_its_rows_and_halo(worlds, model):
    """Every conv, pool and resize input outside the PSP is at most the
    rank's rows at its level plus 6 (the tallest halo as the CPU runs it:
    the fused up site's plain version upsamples 1 + 1 low-res halo rows and
    reflect-pads the result), never the whole level: no rank gathers the
    image.  The level is read from the input's width (W / 2^l, + 2 where
    reflect-padded: distinct for W = 96)."""
    height, width = SHAPES_HW
    spatial = WORLDS["1x2"][1]
    levels = {width // 2 ** l + pad: 2 ** l for l in range(6) for pad in (0, 2)}
    for rank in worlds["1x2"]:
        seen = rank["shapes"][model]
        names = {name for name, _, in_psp in seen if not in_psp}
        assert {"conv2d", "interpolate"} <= names and len(seen) > 50, names
        if model == "segmentor":
            assert any(in_psp for *_, in_psp in seen)
        for name, shape, in_psp in seen:
            if in_psp:
                continue
            scale = levels[shape[3]]
            own, whole = height // spatial // scale, height // scale
            assert own + 6 < whole
            assert shape[2] <= own + 6, (name, shape)


# --- the eval steps ---------------------------------------------------------------

def _loss_bar(got, ref):
    return all(abs(got[k] - float(ref[k])) <= 1e-5 for k in ref) and sorted(got) == sorted(ref)


@pytest.fixture(scope="module")
def footprint_reference(weights):
    """Per FootprintNetwork world: the JAX spatial eval step's losses and
    the JAX single-device '1/1' map (2 compiles each)."""
    jnet, params, state, _ = weights["footprint"]
    config = jstep.TrainStepConfig()
    forward = jax.jit(lambda p, s, x: jnet.apply(p, s, x, train=False)[0]["1/1"])
    out = {}
    for name, shape in FP_SHAPES.items():
        batch = _fp_batch(*shape, 80 if name == "2x2" else 82)
        mesh = _jax_mesh(name)
        losses = jstep.build_eval_step(jnet, config, mesh=mesh)(
            jax.device_put(params, replicated(mesh)), jax.device_put(state, replicated(mesh)),
            jax_shard_batch(mesh, batch))
        out[name] = {"losses": {k: float(v) for k, v in losses.items()},
                     "1/1": np.asarray(forward(params, state, jnp.asarray(batch["image"])))}
    return out


@pytest.mark.parametrize("name", list(FP_SHAPES))
def test_footprint_spatial_eval_matches_the_jax_spatial_eval(worlds, footprint_reference,
                                                             name):
    ref = footprint_reference[name]
    ranks = [r["footprint"] for r in worlds[name]]
    for r in ranks:
        assert r["f32"] == ranks[0]["f32"]  # the same global losses on every rank
    worst = max(abs(ranks[0]["f32"][k] - v) for k, v in ref["losses"].items())
    print(f"{name}: eval losses within {worst:.2e} of the JAX spatial eval")
    assert _loss_bar(ranks[0]["f32"], ref["losses"]), ranks[0]["f32"]
    got = _gather(ranks, WORLDS[name][1], lambda r: r["1/1"], 1)
    assert got.shape == ref["1/1"].shape
    mae = float(np.abs(got - ref["1/1"]).mean())
    print(f"{name}: '1/1' MAE {mae:.2e} to the JAX forward")
    assert mae < 1e-4


@pytest.mark.parametrize("name", list(FP_SHAPES))
def test_bf16_spatial_eval_holds_the_bf16_rule(weights, worlds, name):
    """The row-sharded bf16 eval (packed heads) is no farther from the f32
    eval than twice the port's unsharded bf16 eval is, plus 1e-3."""
    net = worker._footprint_net(weights["footprint"][3])
    batch = {k: torch.from_numpy(v) for k, v in
             _fp_batch(*FP_SHAPES[name], 80 if name == "2x2" else 82).items()}
    f32 = tstep.build_eval_step(net, tstep.TrainStepConfig())(batch)
    bf16 = tstep.build_eval_step(net, tstep.TrainStepConfig(**worker.BF16_HEADS))(batch)
    got = worlds[name][0]["footprint"]["bf16"]
    assert sorted(got) == sorted(bf16)
    assert got != worlds[name][0]["footprint"]["f32"]
    for k, v in f32.items():
        own, ref = abs(got[k] - v.item()), abs(bf16[k].item() - v.item())
        assert own <= 2 * ref + 1e-3, (k, own, ref)


@pytest.fixture(scope="module")
def segmentor_reference(weights):
    """Per Segmentor world: the JAX eval of the seg trainer
    (trainer.py:_build_eval_step's shardings on the world's mesh)."""
    params, state, _ = weights["segmentor"]
    jnet = JaxSegmentor(18, True)

    def eval_fn(p, s, batch):
        outputs, _ = jnet.apply(p, s, batch["image"], train=False)
        return jax_seg_losses(outputs, batch["ground_mask"], batch["labelled_pix"])

    out = {}
    for name in SEG_WORLDS:
        mesh = _jax_mesh(name)
        repl, data = replicated(mesh), batch_sharded(mesh)
        step = jax.jit(eval_fn, in_shardings=(repl, repl, data), out_shardings=repl)
        out[name] = {k: float(v) for k, v in step(params, state, _seg_batch()).items()}
    return out


@pytest.mark.parametrize("name", SEG_WORLDS)
def test_segmentor_spatial_eval_matches_jax(worlds, segmentor_reference, name):
    ranks = [r["segmentor"] for r in worlds[name]]
    for r in ranks:
        assert r == ranks[0]
    worst = max(abs(ranks[0][k] - v) for k, v in segmentor_reference[name].items())
    print(f"{name}: seg eval losses within {worst:.2e} of JAX")
    assert _loss_bar(ranks[0], segmentor_reference[name]), ranks[0]


def test_per_shard_normalisation_would_miss_the_segmentor_bar(weights, segmentor_reference):
    """The seg batch can see the trap: normalising each row shard by its own
    labelled count (then averaging the shards) misses the loss bar by far."""
    net = Segmentor(18, True)
    net.load_state_dict(torch.load(weights["segmentor"][2]), strict=True)
    batch = {k: torch.from_numpy(v) for k, v in _seg_batch().items()}
    with torch.no_grad():
        outputs = net.eval()(batch["image"])
    _, height, width = batch["ground_mask"].shape
    loss = 0.0
    for out in outputs:
        pred = upsample_to(out, height, width)[..., 0]
        masked = bce_with_logits(pred, batch["ground_mask"]) * batch["labelled_pix"]
        halves = [(m.sum((1, 2)) / (v.sum((1, 2)) + 1e-7)) for m, v in
                  zip(masked.chunk(2, 1), batch["labelled_pix"].chunk(2, 1))]
        loss += float(torch.stack(halves).mean()) / len(outputs)
    assert abs(loss - segmentor_reference["1x2"]["loss"]) > 1e-2
