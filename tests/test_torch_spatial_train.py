"""Row-sharded (spatial) training of the port (footprints_tpu_torch/
parallel/halo.py's adjoints, train/step.py and the seg trainer's
build_train_step on ``make_mesh(spatial=k)``) held against the JAX
package's spatial train steps on the CPU.

Worlds of 2 to 4 ranks run in processes joined over gloo
(tests/_torch_dp_worker.py, no JAX there), named by their (data x spatial)
layout.  The JAX references are one compile per model and world on the
virtual CPU devices of tests/conftest.py: ``build_train_step(net, config,
mesh=make_mesh(devices, spatial=k))`` for the FootprintNetwork-18, and the
seg trainer's ``Trainer._build_train_step`` on a spatial ``self.mesh`` (a
Trainer made without its loaders) for the Segmentor-18 (PSP).  Their
gradient is ``jax.grad``'s inside the step: the first Adam moment over
(1 - b1).  Params after Adam are not compared: the first update is about
+-lr at every entry, so a near-zero gradient whose sign flips moves its
param by 2 lr.

Bars, those of tests/test_torch_parallel.py's data-parallel step: loss
terms 1e-5 + 1e-5|ref|, each gradient leaf ||d||/||ref|| < 2e-2, BN running
stats 1e-5; the replicas bitwise equal over the ranks after Adam.  The bf16
steps (the FootprintNetwork's with the packed heads) follow the bf16 rule
of tests/test_torch_bf16_train.py: no farther from the f32 reference than
twice the port's one-process bf16 step is, plus 1e-3 at a loss term and
2^-8 at a gradient leaf (BF16_LEAF_FLOOR says why not 1e-3).  Each halo'd
op's input gradients, the row shards' concatenated, within 1e-5 of the
unsharded op's, and its weight gradients, summed over the shards, within
1e-5 + 1e-5|ref| (sums of a few hundred f32 terms in another order, up to
~20 in size: measured up to 2.1e-5 apart).  The row-sharded BN's values,
gradients and running stats within 1e-5 of the JAX BN on the whole batch.

The gradient reference is jax.grad on one device, not the JAX spatial
step's own gradient: on the 2x2 mesh (data 2 x spatial 2) at 64x96 the JAX
step's gradient is far from jax.grad in the deep encoder (worst leaf 2.28
for the FootprintNetwork, 2.32 for the Segmentor; 1x2: 5.6e-5 and 7.7e-6),
while its losses and BN state agree; the port's 2x2 gradients sit within
6.9e-3 of jax.grad.  test_jax_spatial_steps_own_gradients shows it.

Negative controls: with the halo rows' gradient dropped (the forward-only
exchange) the FootprintNetwork's gradients miss the leaf bar; with an
identity backward at the seg loss's spatial all-reduce the Segmentor's
gradient is 1/k of JAX's.  A backward reached in different orders by two
ranks raises on both.
"""

import types

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from footprints_tpu.models import Segmentor as JaxSegmentor
from footprints_tpu.nn import layers as jl
from footprints_tpu.parallel import make_mesh as jax_make_mesh
from footprints_tpu.preprocessing.segmentation.trainer import Trainer as JaxSegTrainer
from footprints_tpu.train import step as jstep
from footprints_tpu_torch.convert import (jax_params_from_state_dict,
                                          segmentor_jax_params_from_state_dict,
                                          segmentor_state_dict_from_jax_params, unravel_params)
from footprints_tpu_torch.models import Segmentor
from footprints_tpu_torch.parallel.dryrun import spawn

from . import _torch_dp_worker as worker
from ._torch_port import _randomise_bn, jax_model
from .test_torch_parallel import _bn_state_err, _loss_gap
from .test_torch_seg_step import _global_rel, _leaf_rels
from .test_torch_seg_step import _jax_step as _jax_seg_step
from .test_torch_spatial import OPS, _fp_batch, _seg_batch

# (world, spatial) of each world, named data x spatial
WORLDS = {"1x2": (2, 2), "2x2": (4, 2), "1x3": (3, 3)}
TRAIN_WORLDS = ("1x2", "2x2")
FP_SHAPE = (4, 64, 96)
# the 1x3 world's FootprintNetwork step: its middle rank has a seam on each
# side (H / 32 = 3 rows at the deepest level, one a rank)
MIDDLE_SHAPE = (2, 96, 64)
OP_WORLDS = {2: "1x2", 3: "1x3"}
FP_SEED = 80
# the bf16 rule's floor at a gradient leaf: each rank's gradient of a bf16
# parameter copy is rounded to bf16 (8 bits) before the f32 all-reduce, so
# a leaf that one process rounds once (within 2^-9) the k ranks round once
# each; 2^-8 holds two such roundings.  Measured: the Segmentor's outconv3
# bias at 2.2e-3 on 1x2 (4.1e-4 in one process, port and JAX alike).
BF16_LEAF_FLOOR = 2.0 ** -8


def _bn_args():
    rng = np.random.RandomState(55)
    c = 8
    x = (rng.randn(2, 6, 5, c) * 2 + 0.5).astype(np.float32)
    return (x, rng.rand(c).astype(np.float32) + 0.5, rng.randn(c).astype(np.float32),
            rng.randn(c).astype(np.float32), rng.rand(c).astype(np.float32) + 0.1,
            rng.randn(*x.shape).astype(np.float32))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The FootprintNetwork-18 and Segmentor-18 (PSP) weights with
    randomised BN: JAX pytrees, and the port's state_dicts as files."""
    root = tmp_path_factory.mktemp("spatial_train")
    jnet, params, state, net = jax_model(18, seed=5)
    torch.save(net.state_dict(), root / "footprint.pt")
    sd = Segmentor(18, True, generator=torch.Generator().manual_seed(3)).state_dict()
    sparams, sstate = segmentor_jax_params_from_state_dict(sd, 18, True)
    rng = np.random.RandomState(3)
    sparams, sstate = _randomise_bn(sparams, rng), _randomise_bn(sstate, rng)
    torch.save(segmentor_state_dict_from_jax_params(sparams, sstate, 18, True),
               root / "segmentor.pt")
    return {"footprint": (jnet, *jax.tree.map(np.array, (params, state)),
                          str(root / "footprint.pt")),
            "segmentor": (sparams, sstate, str(root / "segmentor.pt"))}


@pytest.fixture(scope="module")
def worlds(weights):
    """{world name: the ranks' results}: one spawn per world."""
    paths = (weights["footprint"][3], weights["segmentor"][2])
    batches = (_fp_batch(*FP_SHAPE, FP_SEED), _seg_batch())
    out = {name: spawn(WORLDS[name][0], worker.spatial_train_rank, *paths, *batches,
                       *((2, _bn_args(), True) if name == "1x2" else ()),
                       device="cpu", spatial=WORLDS[name][1], timeout=600)
           for name in TRAIN_WORLDS}
    out["1x3"] = spawn(3, worker.ops_grad_rank, paths[0], _fp_batch(*MIDDLE_SHAPE, FP_SEED),
                       device="cpu", spatial=3, timeout=600)
    return out


def _jax_mesh(name):
    world, spatial = WORLDS[name]
    return jax_make_mesh(jax.devices()[:world], spatial=spatial)


@pytest.fixture(scope="module")
def footprint_reference(weights):
    """The JAX FootprintNetwork-18 train step's losses, new BN state and
    gradient: per world on its spatial mesh, and on one device (``None``),
    whose gradient is jax.grad of the loss (one compile each)."""
    jnet, params, state, _ = weights["footprint"]
    config = jstep.TrainStepConfig(steps_per_epoch=5)
    batch = {k: jnp.asarray(v) for k, v in _fp_batch(*FP_SHAPE, FP_SEED).items()}
    out = {}
    for name in (None, *TRAIN_WORLDS):
        ts = {"params": params, "state": state,
              "opt_state": jstep.make_optimizer(config).init(params),
              "step": jnp.zeros((), jnp.int32)}
        mesh = None if name is None else _jax_mesh(name)
        new_ts, metrics = jstep.build_train_step(jnet, config, mesh=mesh)(ts, batch)
        new_ts = jax.tree.map(np.asarray, new_ts)
        (count, mu, _), _ = new_ts["opt_state"]
        assert int(count) == 1
        out[name] = {"ts": new_ts, "metrics": {k: float(v) for k, v in metrics.items()},
                     "grad": np.asarray(mu) / 0.1}
    return out


@pytest.fixture(scope="module")
def segmentor_reference(weights):
    """The JAX seg trainer's train step (``_build_train_step``) per world on
    its spatial mesh: losses, new BN state and gradient; and on one device
    (``None``), jax.grad of the same loss (tests/test_torch_seg_step.py)."""
    params, state, _ = weights["segmentor"]
    out = {}
    for name in TRAIN_WORLDS:
        trainer = object.__new__(JaxSegTrainer)
        trainer.net, trainer.mesh = JaxSegmentor(18, True), _jax_mesh(name)
        trainer.optimizer = optax.adam(lambda step: 1e-4)
        trainer.opt = types.SimpleNamespace(compute_dtype=None)
        ts = {"params": params, "state": state, "opt_state": trainer.optimizer.init(params),
              "step": np.zeros((), np.int32)}
        new_ts, losses = trainer._build_train_step()(ts, _seg_batch())
        new_ts = jax.tree.map(np.asarray, new_ts)
        out[name] = {"state": new_ts["state"], "losses": {k: float(v) for k, v in losses.items()},
                     "grad": jax.tree.map(lambda m: m / 0.1, new_ts["opt_state"][0].mu)}
    grad, _, losses = _jax_seg_step(True, False, params, state,
                                    {k: jnp.asarray(v) for k, v in _seg_batch().items()})
    out[None] = {"grad": grad, "losses": {k: float(v) for k, v in losses.items()}}
    return out


def _fp_grads(result, template_sd):
    """The port's FootprintNetwork gradient (rank 0's, averaged) as a JAX
    pytree; leaves without a gradient are zeros."""
    grads = {k: np.zeros(v.shape, np.float32) for k, v in template_sd.items()}
    grads.update(result["grads"])
    return jax_params_from_state_dict({k: torch.from_numpy(v) for k, v in grads.items()},
                                      18)[0]


def _fp_ref_grads(result, ref):
    template = jax_params_from_state_dict(
        {k: torch.from_numpy(v) for k, v in result["state_dict"].items()}, 18)[0]
    return unravel_params(ref["grad"], template)


def _seg_grads(result):
    grads = {k: np.zeros(v.shape, np.float32) for k, v in result["state_dict"].items()}
    grads.update(result["grads"])
    return segmentor_jax_params_from_state_dict(grads, 18, True)[0]


def _seg_bn_err(result, ref):
    got = segmentor_jax_params_from_state_dict(result["state_dict"], 18, True)[1]
    return max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
               for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref["state"])))


def _worst(rels):
    worst = max(rels, key=rels.get)
    return worst, rels[worst]


# --- the halo'd ops' gradients ---------------------------------------------------

@pytest.fixture(scope="module")
def op_references():
    return {spatial: worker.op_gradients(None, spatial) for spatial in OP_WORLDS}


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("spatial", list(OP_WORLDS))
def test_halo_op_gradients_match_the_unsharded_op(worlds, op_references, spatial, op):
    """The row shards' input gradients, concatenated over the ranks, and
    their weight gradients, summed, are the unsharded op's."""
    ref = op_references[spatial][op]
    ranks = [r["ops"][op] for r in worlds[OP_WORLDS[spatial]]]
    assert all(sorted(r) == sorted(ref) for r in ranks), (sorted(ranks[0]), sorted(ref))
    assert any(k in worker.ROW_LEAVES for k in ref)
    for leaf, want in ref.items():
        if leaf in worker.ROW_LEAVES:
            got, rtol = np.concatenate([r[leaf] for r in ranks], 2), 0
        else:
            got, rtol = np.sum([r[leaf] for r in ranks], 0), 1e-5
        assert got.shape == want.shape, leaf
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=rtol, err_msg=leaf)


# --- BN statistics over row shards ------------------------------------------------

def test_row_sharded_batch_norm_takes_the_whole_batch_statistics(worlds):
    """Train-mode BN with the world's group (sync_batch_norm), each rank on
    its rows of every image: the whole batch's mean and variance, as JAX's
    BN on the unsharded batch."""
    x, scale, bias, mean, var, cot = _bn_args()
    params, state = {"scale": scale, "bias": bias}, {"mean": mean, "var": var}
    (ref, ref_state), vjp = jax.vjp(lambda x, p: jl.batch_norm(x, p, state, train=True),
                                    jnp.asarray(x), params)
    dx_ref, dp_ref = vjp((jnp.asarray(cot), jax.tree.map(jnp.zeros_like, ref_state)))
    ranks = [r["bn"] for r in worlds["1x2"]]
    np.testing.assert_allclose(np.concatenate([r["y"] for r in ranks], 1), ref, atol=1e-5)
    np.testing.assert_allclose(np.concatenate([r["dx"] for r in ranks], 1), dx_ref, atol=1e-5)
    for r in ranks:
        np.testing.assert_allclose(r["mean"], ref_state["mean"], atol=1e-5)
        np.testing.assert_allclose(r["var"], ref_state["var"], atol=1e-5)
        np.testing.assert_allclose(r["dw"], dp_ref["scale"], atol=1e-5)
        np.testing.assert_allclose(r["db"], dp_ref["bias"], atol=1e-5)


# --- the train steps ----------------------------------------------------------

@pytest.mark.parametrize("name", TRAIN_WORLDS)
def test_footprint_spatial_step_matches_the_jax_spatial_step(worlds, footprint_reference,
                                                             name):
    ref = footprint_reference[name]
    result = worlds[name][0]["footprint"]
    gap = _loss_gap(result["losses"], ref["metrics"])
    assert gap <= 0, (result["losses"], ref["metrics"])
    assert result["lr"] == pytest.approx(ref["metrics"]["lr"], rel=1e-6)
    got = _fp_grads(result, result["state_dict"])
    want = _fp_ref_grads(result, footprint_reference[None])
    path, worst = _worst(_leaf_rels(got, want))
    print(f"{name}: worst gradient leaf {path}: {worst:.2e}")
    assert worst < 2e-2, (path, worst)
    assert len(result["grads"]) == len(jax.tree.leaves(want))
    assert _bn_state_err(result["state_dict"], ref["ts"]) <= 1e-5


@pytest.mark.parametrize("name", TRAIN_WORLDS)
def test_segmentor_spatial_step_matches_the_jax_spatial_step(worlds, segmentor_reference,
                                                             name):
    ref = segmentor_reference[name]
    result = worlds[name][0]["segmentor"]
    assert sorted(result["losses"]) == sorted(ref["losses"])
    for k, v in ref["losses"].items():
        assert abs(result["losses"][k] - v) <= 1e-5 + 1e-5 * abs(v), (k, result["losses"][k], v)
    want = segmentor_reference[None]["grad"]
    path, worst = _worst(_leaf_rels(_seg_grads(result), want))
    print(f"{name}: worst gradient leaf {path}: {worst:.2e}")
    assert worst < 2e-2, (path, worst)
    assert len(result["grads"]) == len(jax.tree.leaves(want))
    assert _seg_bn_err(result, ref) <= 1e-5


def test_footprint_step_with_a_middle_rank_matches_one_process(weights, worlds):
    """The 1x3 world, whose middle rank exchanges and adjoins at both
    seams, against the port's one-process step (which
    tests/test_torch_train_step.py holds to JAX) at the same bars."""
    from footprints_tpu_torch import parallel

    ref = worker.spatial_step_rank(parallel.make_mesh("cpu"), "footprint",
                                   weights["footprint"][3], _fp_batch(*MIDDLE_SHAPE, FP_SEED))
    result = worlds["1x3"][0]["footprint"]
    assert _loss_gap(result["losses"], {**ref["losses"], "lr": ref["lr"]}) <= 0
    rels = {k: np.linalg.norm(result["grads"][k] - v) / max(np.linalg.norm(v), 1e-12)
            for k, v in ref["grads"].items()}
    path, worst = _worst(rels)
    print(f"1x3: worst gradient leaf {path}: {worst:.2e}")
    assert result["grads"].keys() == ref["grads"].keys() and worst < 2e-2, (path, worst)
    for k, v in ref["state_dict"].items():
        if "running" in k:
            np.testing.assert_allclose(result["state_dict"][k], v, atol=1e-5, err_msg=k)
    assert len({r["footprint"]["digest"] for r in worlds["1x3"]}) == 1


@pytest.mark.parametrize("name", TRAIN_WORLDS)
@pytest.mark.parametrize("model", ["footprint", "segmentor"])
def test_replicas_are_bitwise_equal_after_the_spatial_step(worlds, name, model):
    assert len({r[model]["digest"] for r in worlds[name]}) == 1


@pytest.mark.parametrize("model", ["footprint", "segmentor"])
def test_every_exchange_but_the_images_runs_its_adjoint(worlds, model):
    """Each rank runs the adjoint of every exchange of its forward but the
    stem conv's exchange of the image, which needs no gradient."""
    for name in TRAIN_WORLDS:
        forward, backward = worlds[name][0][model]["exchanges"]
        assert forward > 40 and backward == forward - 1, (name, forward, backward)
        assert all(r[model]["exchanges"] == [forward, backward] for r in worlds[name])


def _one_process_bf16(model, weights, batch):
    """The port's one-process bf16 step's result (tests/_torch_dp_worker.py
    on a world of one)."""
    from footprints_tpu_torch import parallel

    config = worker.BF16_HEADS if model == "footprint" else {"compute_dtype": "bfloat16"}
    path = weights[model][3] if model == "footprint" else weights[model][2]
    return worker.spatial_step_rank(parallel.make_mesh("cpu"), model, path, batch, config)


@pytest.mark.parametrize("model", ["footprint", "segmentor"])
def test_bf16_spatial_step_holds_the_bf16_rule(weights, worlds, footprint_reference,
                                               segmentor_reference, model):
    """The 1x2 bf16 step (the FootprintNetwork's with the packed heads) no
    farther from the f32 reference (the JAX spatial step's losses, jax.grad)
    than twice the port's one-process bf16 step, plus 1e-3 at each loss
    term and BF16_LEAF_FLOOR at each gradient leaf, and no farther as a
    whole gradient than twice."""
    batch = _fp_batch(*FP_SHAPE, FP_SEED) if model == "footprint" else _seg_batch()
    single = _one_process_bf16(model, weights, batch)
    got = worlds["1x2"][0][f"{model}_bf16"]
    if model == "footprint":
        ref_losses = footprint_reference["1x2"]["metrics"]
        ref_grad = _fp_ref_grads(got, footprint_reference[None])
        as_tree = lambda r: _fp_grads(r, r["state_dict"])  # noqa: E731
    else:
        ref_losses = segmentor_reference["1x2"]["losses"]
        ref_grad, as_tree = segmentor_reference[None]["grad"], _seg_grads
    assert got["losses"] != worlds["1x2"][0][model]["losses"]
    for k, v in got["losses"].items():
        own, one = abs(v - ref_losses[k]), abs(single["losses"][k] - ref_losses[k])
        assert own <= 2 * one + 1e-3, (k, own, one)
    own, one = _leaf_rels(as_tree(got), ref_grad), _leaf_rels(as_tree(single), ref_grad)
    bad = {k: (own[k], one[k]) for k in own if own[k] > 2 * one[k] + BF16_LEAF_FLOOR}
    print(f"{model} bf16: whole gradient {_global_rel(as_tree(got), ref_grad):.3f} from f32, "
          f"one process {_global_rel(as_tree(single), ref_grad):.3f}")
    assert not bad, bad
    assert _global_rel(as_tree(got), ref_grad) <= 2 * _global_rel(as_tree(single), ref_grad)


# --- negative controls and the order check --------------------------------------

def test_detached_halos_miss_the_gradient_bar(worlds, footprint_reference):
    """The forward-only exchange (halo rows' gradient dropped): the same
    step's gradients miss the 2e-2 leaf bar the adjoint meets."""
    result = worlds["1x2"][0]["footprint_detached"]
    assert _loss_gap(result["losses"], footprint_reference["1x2"]["metrics"]) <= 0
    path, worst = _worst(_leaf_rels(_fp_grads(result, result["state_dict"]),
                                    _fp_ref_grads(result, footprint_reference[None])))
    print(f"detached halos: worst gradient leaf {path}: {worst:.2e}")
    assert worst > 2e-2
    assert result["exchanges"][1] == 0


def test_identity_backward_at_the_seg_loss_sum_gives_1_over_k(worlds, segmentor_reference):
    """An identity backward at the seg loss's all-reduce over the k = 2
    spatial ranks: every leaf of the gradient comes out 1/k of JAX's, far
    outside the bar, and k times it is inside."""
    result = worlds["1x2"][0]["segmentor_identity"]
    want = segmentor_reference[None]["grad"]
    grads = _seg_grads(result)
    rels = _leaf_rels(grads, want)
    path, scaled = _worst(_leaf_rels(jax.tree.map(lambda g: 2 * g, grads), want))
    print(f"identity backward: leaves {min(rels.values()):.3f}-{max(rels.values()):.3f} "
          f"from JAX; x2: worst {path} {scaled:.2e}")
    assert 0.5 - 2e-2 < min(rels.values()) and max(rels.values()) < 0.5 + 2e-2
    assert scaled < 2e-2


def test_backwards_in_different_orders_raise_on_every_rank(worlds):
    """Two exchanges of one shape whose backwards the two ranks run in
    opposite orders: each rank raises on the sequence numbers, and no
    strip of one exchange is added to the other's gradient."""
    for message in (r["mismatch"] for r in worlds["1x2"]):
        assert message is not None and "sequence numbers" in message, message


@pytest.mark.parametrize("model", ["footprint", "segmentor"])
def test_jax_spatial_steps_own_gradients(footprint_reference, segmentor_reference, model):
    """A property of the reference, pinned: the JAX spatial step's own
    gradient meets the leaf bar against jax.grad on one device at 1x2 and
    misses it at 2x2 (module doc), which is why the port's gradients are
    held to jax.grad."""
    refs = footprint_reference if model == "footprint" else segmentor_reference
    for name in TRAIN_WORLDS:
        if model == "footprint":
            got = unravel_params(refs[name]["grad"], refs[None]["ts"]["params"])
            want = unravel_params(refs[None]["grad"], refs[None]["ts"]["params"])
        else:
            got, want = refs[name]["grad"], refs[None]["grad"]
        path, worst = _worst(_leaf_rels(got, want))
        print(f"JAX {model} {name}: worst leaf {path}: {worst:.2e}")
        assert (worst < 2e-2) == (name == "1x2"), (name, path, worst)
