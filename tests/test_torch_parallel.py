"""The port's data-parallel layer (footprints_tpu_torch/parallel/) held
against the JAX package's mesh step on the CPU.

Worlds of 2 and 4 ranks run in processes joined over gloo
(tests/_torch_dp_worker.py, no JAX there); the JAX reference is one
compile of ``build_train_step(..., mesh=make_mesh(jax.devices()[:4]))``
on the virtual CPU devices of tests/conftest.py.

Tolerances, those of tests/test_torch_train_step.py: global-batch BN
values, running stats and input/weight gradients 1e-5 (short f32
reductions); the FootprintNetwork-18 step (64x96, global batch 4) loss
terms 1e-5 + 1e-5|ref|, BN running stats 1e-5, each gradient leaf
||d||/||ref|| < 2e-2 (near-cancelling encoder gradients move by ~1e-3
relative from summation order alone).  The updated replicas are bitwise
equal across ranks.  The same step with per-rank BN statistics (DDP's
default) misses the loss and BN-state bars: the test can see that trap.
The Segmentor-18 world-2 step is held to the port's own world-1 step
(which tests/test_torch_seg_step.py holds to JAX) at the same bars.

Measured: the world-4 step's worst leaf sits 6.5e-6 from JAX's 4-device
step; world 2's 5.5e-3 (the stem conv), and the Segmentor's world 2
7.0e-3 from its world 1.  The Segmentor's was traced to one ReLU
pre-activation 3.2e-6 from 0 whose sign the summation order flips (an f64
world-2 step equals an f64 world-1 step to 1e-14): the kink, not the
all-reduce.
"""

import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from footprints_tpu.nn import layers as jl
from footprints_tpu.parallel import distributed as jdist
from footprints_tpu.parallel import make_mesh as jax_make_mesh
from footprints_tpu.train import step as jstep
from footprints_tpu_torch import parallel
from footprints_tpu_torch.convert import jax_params_from_state_dict, unravel_params
from footprints_tpu_torch.data.loader import DataLoader
from footprints_tpu_torch.parallel.dryrun import spawn

from . import _torch_dp_worker as worker
from ._torch_port import jax_model
from .test_torch_train_step import _targets, _worst_leaf

H, W, N = 64, 96, 4
WORLDS = (2, 4)


# --- distributed.py / mesh.py in one process -----------------------------

@pytest.mark.parametrize("global_batch,world", [(8, 1), (8, 2), (8, 4), (12, 3), (6, 6)])
def test_host_batch_slice_matches_jax(monkeypatch, global_batch, world):
    for rank in range(world):
        monkeypatch.setattr(jax, "process_count", lambda: world)
        monkeypatch.setattr(jax, "process_index", lambda: rank)
        assert parallel.host_batch_slice(global_batch, world, rank) == \
            jdist.host_batch_slice(global_batch)


def test_host_batch_slice_raises_as_jax_does(monkeypatch):
    monkeypatch.setattr(jax, "process_count", lambda: 3)
    monkeypatch.setattr(jax, "process_index", lambda: 0)
    with pytest.raises(AssertionError) as ref:
        jdist.host_batch_slice(8)
    with pytest.raises(AssertionError) as got:
        parallel.host_batch_slice(8, 3, 0)
    assert str(got.value) == str(ref.value)


def test_single_process_is_a_world_of_one(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert parallel.initialize(device="cpu") is False
    assert not torch.distributed.is_initialized()
    mesh = parallel.make_mesh("cpu")
    assert (mesh.world_size, mesh.rank, mesh.group, mesh.distributed) == (1, 0, None, False)
    batch = {"a": np.arange(8.0).reshape(4, 2)}
    assert torch.equal(parallel.shard_batch(mesh, batch)["a"], torch.from_numpy(batch["a"]))
    assert parallel.any_rank(mesh, True) and not parallel.any_rank(mesh, False)
    assert mesh.shard == (0, 1) and parallel.rank_seed(10, mesh.shard) == 10
    assert parallel.rank_seed(10, (1, 2)) == (10, 1)


def test_local_rank_beyond_the_cards_raises(monkeypatch):
    monkeypatch.setenv("LOCAL_RANK", str(torch.cuda.device_count()))
    with pytest.raises(RuntimeError, match="CUDA device"):
        parallel.local_device("cuda")
    assert parallel.local_device("cpu") == torch.device("cpu")
    assert parallel.local_device("cuda:0") == torch.device("cuda", 0)


class _Indices:
    def __len__(self):
        return 26

    def __getitem__(self, i):
        return {"i": np.asarray(i)}


@pytest.mark.parametrize("world", [2, 3, 4])
def test_sharded_loader_rows_make_world_1_batches(world):
    """Each rank's rows of each global batch of the shared seeded
    permutation: together, in rank order, world 1's batches."""
    def batches(shard):
        return [b["i"] for b in DataLoader(_Indices(), 12, shuffle=True, num_workers=2,
                                           seed=7, shard=shard)]

    whole = batches((0, 1))
    ranks = [batches((r, world)) for r in range(world)]
    assert len(whole) == 2 and all(len(r) == len(whole) for r in ranks)
    for b, parts in zip(whole, zip(*ranks)):
        np.testing.assert_array_equal(np.concatenate(parts), b)
    with pytest.raises(ValueError, match="must divide over 5 ranks"):
        DataLoader(_Indices(), 12, shard=(0, 5))


def test_a_failed_rank_fails_the_spawn():
    """No rank's failure is hidden: spawn raises with its traceback, and
    ends the rank left waiting in a collective."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed:(.|\n)*fails on purpose"):
        spawn(2, worker.failing_rank, device="cpu", timeout=120)
    assert time.monotonic() - t0 < 120


# --- the worlds -------------------------------------------------------------

def _bn_args():
    rng = np.random.RandomState(50)
    c = 8
    x = (rng.randn(N, 5, 6, c) * 2 + 0.5).astype(np.float32)
    return (x, rng.rand(c).astype(np.float32) + 0.5, rng.randn(c).astype(np.float32),
            rng.randn(c).astype(np.float32), rng.rand(c).astype(np.float32) + 0.1,
            rng.randn(*x.shape).astype(np.float32))


def _seg_batch():
    rng = np.random.RandomState(51)
    return {"image": rng.rand(N, H, W, 3).astype(np.float32),
            "ground_mask": (rng.rand(N, H, W) > 0.5).astype(np.float32),
            "labelled_pix": (rng.rand(N, H, W) > 0.2).astype(np.float32)}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX mesh step (one compile, 4 devices), the weights it started
    from as the port's state_dict file, and the batch."""
    jnet, params, state, net = jax_model(18, seed=5)
    params, state = jax.tree.map(np.array, (params, state))
    path = tmp_path_factory.mktemp("dp") / "weights.pt"
    torch.save(net.state_dict(), path)
    rng = np.random.RandomState(52)
    batch = {"image": rng.rand(N, H, W, 3).astype(np.float32), **_targets(N, H, W, 53)}
    jconfig = jstep.TrainStepConfig(steps_per_epoch=5)
    mesh = jax_make_mesh(jax.devices()[:4])
    ts = {"params": params, "state": state,
          "opt_state": jstep.make_optimizer(jconfig).init(params),
          "step": jnp.zeros((), jnp.int32)}
    new_ts, metrics = jstep.build_train_step(jnet, jconfig, mesh=mesh)(
        ts, {k: jnp.asarray(v) for k, v in batch.items()})
    return {"ts": jax.tree.map(np.asarray, new_ts),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "weights": str(path), "batch": batch}


@pytest.fixture(scope="module")
def worlds(reference):
    """{world: the ranks' results}: one spawn per world."""
    return {w: spawn(w, worker.parallel_rank, reference["weights"], reference["batch"],
                     _seg_batch(), _bn_args(), device="cpu", timeout=600)
            for w in WORLDS}


@pytest.mark.parametrize("world", WORLDS)
def test_global_batch_norm_matches_jax_on_the_whole_batch(worlds, world):
    x, scale, bias, mean, var, cot = _bn_args()
    params, state = {"scale": scale, "bias": bias}, {"mean": mean, "var": var}

    def f(x, p):
        return jl.batch_norm(x, p, state, train=True)

    (ref, ref_state), vjp = jax.vjp(f, jnp.asarray(x), params)
    dx_ref, dp_ref = vjp((jnp.asarray(cot), jax.tree.map(jnp.zeros_like, ref_state)))
    ranks = [r["bn"] for r in worlds[world]]
    np.testing.assert_allclose(np.concatenate([r["y"] for r in ranks]), ref, atol=1e-5)
    np.testing.assert_allclose(np.concatenate([r["dx"] for r in ranks]), dx_ref, atol=1e-5)
    for r in ranks:
        np.testing.assert_allclose(r["dw"], dp_ref["scale"], atol=1e-5)
        np.testing.assert_allclose(r["db"], dp_ref["bias"], atol=1e-5)
        np.testing.assert_allclose(r["mean"], ref_state["mean"], atol=1e-5)
        np.testing.assert_allclose(r["var"], ref_state["var"], atol=1e-5)


def _loss_gap(got, ref):
    """The largest |got - ref| - (1e-5 + 1e-5|ref|) over the loss terms."""
    assert sorted(got) == sorted(k for k in ref if k != "lr")
    return max(abs(got[k] - ref[k]) - (1e-5 + 1e-5 * abs(ref[k])) for k in got)


def _bn_state_err(state_dict, ref_ts):
    got = jax_params_from_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()},
                                     18)[1]
    return max(float(np.abs(a - b).max()) for a, b in
               zip(jax.tree.leaves(got), jax.tree.leaves(ref_ts["state"])))


@pytest.mark.parametrize("world", WORLDS)
def test_footprint_step_matches_the_jax_mesh_step(reference, worlds, world):
    ranks = [r["footprint"]["global"] for r in worlds[world]]
    ref_ts, ref_metrics = reference["ts"], reference["metrics"]
    for r in ranks:
        assert _loss_gap(r["losses"], ref_metrics) <= 0, r["losses"]
        assert r["lr"] == pytest.approx(ref_metrics["lr"], rel=1e-6)
    # the gradient: JAX's is its first Adam moment over (1 - b1)
    (count, mu, _), _ = ref_ts["opt_state"]
    assert int(count) == 1
    sd = {k: torch.from_numpy(v) for k, v in ranks[0]["state_dict"].items()}
    template = jax_params_from_state_dict(sd, 18)[0]
    grads = {k: np.zeros(tuple(v.shape), np.float32) for k, v in sd.items()}
    grads.update(ranks[0]["grads"])
    worst, path = _worst_leaf(jax_params_from_state_dict(grads, 18)[0],
                              unravel_params(np.asarray(mu) / 0.1, template))
    print(f"world {world}: worst gradient leaf {path}: {worst:.2e}")
    assert worst < 2e-2, (path, worst)
    assert len(ranks[0]["grads"]) == len(jax.tree.leaves(template))
    assert _bn_state_err(ranks[0]["state_dict"], ref_ts) <= 1e-5


@pytest.mark.parametrize("world", WORLDS)
def test_replicas_are_bitwise_equal(worlds, world):
    for kind in ("footprint",) + (("segmentor",) if world == 2 else ()):
        results = [r[kind]["global"] if kind == "footprint" else r[kind]
                   for r in worlds[world]]
        assert len({r["digest"] for r in results}) == 1, kind


@pytest.mark.parametrize("world", WORLDS)
def test_per_rank_bn_misses_the_bars(reference, worlds, world):
    """DDP's default, BN statistics of each rank's rows alone: the same
    step then misses the loss and the BN-state bars the global BN meets."""
    per_rank = worlds[world][0]["footprint"]["per_rank"]
    loss_gap = _loss_gap(per_rank["losses"], reference["metrics"])
    bn_err = _bn_state_err(per_rank["state_dict"], reference["ts"])
    print(f"world {world}, per-rank BN: loss terms over their bar by {loss_gap:.2e}, "
          f"BN state off by {bn_err:.2e}")
    assert loss_gap > 0 and bn_err > 1e-5



def test_segmentor_world_2_matches_world_1(worlds):
    ref = worker.segmentor_step_rank(parallel.make_mesh("cpu"), _seg_batch())
    got = worlds[2][0]["segmentor"]
    for k, v in ref["losses"].items():
        assert abs(got["losses"][k] - v) <= 1e-5 + 1e-5 * abs(v), k
    rel = {k: np.linalg.norm(got["grads"][k] - v) / max(np.linalg.norm(v), 1e-12)
           for k, v in ref["grads"].items()}
    assert got["grads"].keys() == ref["grads"].keys()
    worst = max(rel, key=rel.get)
    print(f"segmentor world 2 vs 1: worst gradient leaf {worst}: {rel[worst]:.2e}")
    assert rel[worst] < 2e-2
    for k, v in ref["state_dict"].items():
        if "running" in k:
            np.testing.assert_allclose(got["state_dict"][k], v, atol=1e-5, err_msg=k)
