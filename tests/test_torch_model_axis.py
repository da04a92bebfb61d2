"""The rest of the model axis, on the CPU: GPipe over stages (k2b) and
tensor and expert sharding (k2c), gloo ranks of the port against the
JAX package's ``shard_map`` and ``NetTrainer`` on CPU devices.

One job of two rank processes (``tests/torch_sp_rank.py``, a ``1 x 2``
mesh) and one of four (a ``2 x 2`` mesh; its GPipe check over four
stages):

* ``pipeline_apply`` over 2 and 4 stages (a relu-MLP stack, each rank
  on its stage): the output and the gradients of ``sum(o * w)`` for the
  rows and for every stage's tensors against ``jax.grad`` of the JAX
  ``pipeline_apply`` (``gpipe`` under ``shard_map``), within
  ``PIPE_ATOL``.  A sum over stages that handed a stage the output's
  gradient twice, or a hop whose backward went the wrong way, fails
  these.
* Nets trained 3 SGD steps at ``model_parallel = 2`` against the JAX
  trainer on the same mesh (``NET_RTOL``, ``NET_ATOL``, the JAX tests'
  bound for these nets): an inception-style conv net (a sibling-1x1
  group cut per member, one with an uncut member that is gathered,
  a plain conv, batch norm's vectors gathered at use, a cut ``fullc``),
  the MoE net (two experts a rank), ``pipe_mlp`` and
  ``transformer_conf(pipeline_parallel = 2)`` on both meshes, and the
  conv + batch norm + ``fullc`` net under ``zero = 1`` and ``3`` on the
  ``2 x 2`` mesh.  The updaters that read whole-tensor norms on cut tensors,
  on the ``1 x 2`` mesh: the transformer's stages under ``lars`` and
  the MoE net under ``lamb`` (a stage that ran every block, or a norm
  of a rank's slice only, fails these).  Each rank's tensors (``s:``) have the JAX package's shard
  shapes of its params, and under ``zero = 1`` its updater slots
  (``u:``) those of its state; the MoE net holds half the state a rank.
* The inception net's checkpoint from the ``m = 2`` job (written by
  ``save_model``) loads into a one-rank port and into the JAX package
  bit for bit; the job itself starts from a JAX-written checkpoint.
  ``get_weight`` gathers the whole tensor, ``set_weight`` writes each
  rank's slice back.  The integrity plane digests each slice at its
  place in the whole leaf: a cut leaf has one group per slice, and one
  replica of each slice combines into JAX's layout-invariant digest of
  the gathered whole.

In one process: ``MeshPlan.model_dim`` and ``owner_dim`` against the
JAX ``param_sharding`` and ``state_sharding`` on 1 x 2, 2 x 2 and 1 x 4
meshes, and the block stacks' stage checks against the JAX messages.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu.integrity.fingerprint import digest_global
from cxxnet_tpu.io.data import DataBatch as JaxBatch
from cxxnet_tpu.layers import create_layer as jax_layer
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
from cxxnet_tpu.ops import pipeline as jpipeline
from cxxnet_tpu.parallel import make_mesh

from cxxnet_tpu_torch import config as tcfg
from cxxnet_tpu_torch import models as tmodels
from cxxnet_tpu_torch.layers import create_layer
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.parallel import mesh as tmesh

from test_torch_moe_pipe import MOE_CFG, PIPE_MLP_CFG  # noqa: E402
from test_torch_parallel_dp import NET as BN_NET  # noqa: E402
from test_torch_parallel_dp import run_ranks as _run_ranks  # noqa: E402

PIPE_ATOL = 2e-5
NET_RTOL, NET_ATOL = 3e-4, 3e-5
STEPS = 3

INCEP_CFG = [
    ("dev", "cpu"), ("batch_size", "8"), ("input_shape", "8,6,6"),
    ("eta", "0.1"), ("momentum", "0.9"), ("seed", "4"),
    ("netconfig", "start"),
    # a sibling-1x1 group whose members are both cut: 3 + 2 columns a rank
    ("layer[0->1]", "conv:r3"), ("kernel_size", "1"), ("nchannel", "6"),
    ("init_sigma", "0.2"),
    ("layer[0->2]", "conv:r5"), ("kernel_size", "1"), ("nchannel", "4"),
    ("init_sigma", "0.2"),
    ("layer[1->1]", "relu"),
    ("layer[1->3]", "conv:c3"), ("kernel_size", "3"), ("pad", "1"),
    ("nchannel", "8"), ("init_sigma", "0.2"),
    ("layer[3->3]", "batch_norm:bn"),
    ("layer[2->4]", "conv:c5"), ("kernel_size", "5"), ("pad", "2"),
    ("nchannel", "4"), ("init_sigma", "0.2"),
    ("layer[3,4->5]", "ch_concat"),
    ("layer[5->5]", "relu"),
    # a group with an uncut member (3 channels): gathered, run whole
    ("layer[5->6]", "conv:p1"), ("kernel_size", "1"), ("nchannel", "4"),
    ("init_sigma", "0.2"),
    ("layer[5->7]", "conv:p2"), ("kernel_size", "1"), ("nchannel", "3"),
    ("init_sigma", "0.2"),
    ("layer[6,7->8]", "ch_concat"),
    ("layer[8->9]", "flatten"),
    ("layer[9->10]", "fullc:fc"), ("nhidden", "4"), ("init_sigma", "0.1"),
    ("layer[10->10]", "softmax"),
    ("netconfig", "end"),
]
WEIGHTS = [("fc", "wmat"), ("c3", "wmat"), ("bn", "wmat"), ("p2", "bias")]
ZERO_CFG = tcfg.parse_pairs(
    BN_NET.replace("layer[4->4] = dropout\n  threshold = 0.3\n", "")
    + "dev = cpu\n") + [("zero", "1")]
# zero = 3 over the model axis: the data slices gathered at a step's
# start (the gather at use runs without a model axis)
ZERO3_CFG = ZERO_CFG[:-1] + [("zero", "3")]


def tf_pairs(batch):
    conf = tmodels.transformer_conf(
        batch_size=batch, seq_len=8, dim=16, nhead=2, nlayer=4, num_class=4,
        dev="cpu", compute_dtype="float32", pipeline_parallel=2,
        n_microbatch=4)
    return tcfg.parse_pairs(conf)


#: run name -> (conf pairs, input shape of a row, classes, init writer)
NETS = {
    "incep": (INCEP_CFG, (6, 6, 8), 4, "jax"),
    "moe": (MOE_CFG, (10,), 4, "port"),
    "pipe": (PIPE_MLP_CFG, (16,), 4, "port"),
    "tf": (None, (8, 16), 4, "port"),
    "zero": (ZERO_CFG, (8, 8, 3), 4, "port"),
    "zero3": (ZERO3_CFG, (8, 8, 3), 4, "port"),
    "tf_lars": (None, (8, 16), 4, "port"),
    "moe_lamb": (MOE_CFG, (10,), 4, "port"),
}
#: run name -> the keys it adds to its net's conf
EXTRA = {"tf_lars": [("updater", "lars"), ("trust_coeff", "1")],
         "moe_lamb": [("updater", "lamb"), ("eta", "0.01")]}


@pytest.fixture(autouse=True, scope="module")
def _jax_obs_registry_as_found():
    """As in ``test_torch_train.py``: drop the empty device-plane
    histogram the JAX trainer's compile listener registers."""
    from cxxnet_tpu.obs import device as obs_device
    from cxxnet_tpu.obs import registry

    name = "train_step_device_seconds"
    had = any(m.name == name for m in registry().metrics())
    yield
    reg = registry()
    fam = next((m for m in reg.metrics() if m.name == name), None)
    if not had and fam is not None and not fam.samples():
        with reg._lock:
            reg._metrics.pop(name, None)
        obs_device.reset()


def _pairs(name, batch):
    pairs = NETS[name][0]
    if pairs is None:
        pairs = [p for p in tf_pairs(batch) if p[0] != "model_parallel"]
    return [(k, str(batch) if k == "batch_size" else v)
            for k, v in pairs + EXTRA.get(name, [])]


def _init(name, batch, path):
    """The run's first checkpoint, written by the package ``NETS``
    names."""
    tr = JaxTrainer() if NETS[name][3] == "jax" else NetTrainer()
    tr.set_params(_pairs(name, batch))
    tr.init_model()
    tr.save_model(path)


def _batches(name, batch, path, seed):
    _, row, ncls, _ = NETS[name]
    rng = np.random.RandomState(seed)
    np.savez(path,
             data=rng.randn(STEPS, batch, *row).astype(np.float32),
             label=rng.randint(0, ncls, (STEPS, batch, 1)).astype(
                 np.float32))


def _pipe_npz(path, l, seed):
    rng = np.random.RandomState(seed)
    np.savez(path, w=rng.randn(l, 16, 16).astype(np.float32) * 0.3,
             b=rng.randn(l, 16).astype(np.float32) * 0.1,
             x=rng.randn(8, 16).astype(np.float32),
             w_out=rng.randn(8, 16).astype(np.float32))


def _job(tmp, world, names, batch, stages, micro, extra=None,
         finetune=None):
    pipe = os.path.join(tmp, "gpipe.npz")
    _pipe_npz(pipe, 4, world)
    runs = []
    for i, name in enumerate(names):
        init = os.path.join(tmp, f"{name}_init.model")
        bat = os.path.join(tmp, f"{name}.npz")
        _init(name, batch, init)
        _batches(name, batch, bat, 10 * world + i)
        run = dict(cfg=_pairs(name, batch) + [("model_parallel", "2")],
                   init=init, batches=bat, steps=STEPS,
                   out=os.path.join(tmp, name))
        run.update((extra or {}).get(name, {}))
        runs.append(run)
    if finetune:  # its first checkpoint's layers copied into a fresh net
        runs.append(dict(runs[names.index(finetune)], steps=0,
                         finetune=os.path.join(tmp, f"{finetune}_init.model"),
                         out=os.path.join(tmp, "finetune"), save=None,
                         weights=[]))
    _run_ranks({"runs": runs, "pipe": pipe, "pipe_model_parallel": stages,
                "pipe_microbatch": micro,
                "pipe_out": os.path.join(tmp, "gpipe")},
               tmp, world, script="torch_sp_rank.py")
    return {"tmp": tmp, "world": world, "batch": batch, "stages": stages,
            "micro": micro}


@pytest.fixture(scope="module")
def job2(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mp2"))
    save = os.path.join(tmp, "incep_m2.model")
    job = _job(tmp, 2, ["incep", "moe", "pipe", "tf", "tf_lars",
                        "moe_lamb"], 8, 2, 4,
               {"incep": {"save": save, "weights": WEIGHTS}},
               finetune="incep")
    return dict(job, save=save)


@pytest.fixture(scope="module")
def job4(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mp4"))
    return _job(tmp, 4, ["zero", "zero3", "tf", "pipe", "moe"], 16, 4, 2)


def _load(job, name):
    return [dict(np.load(os.path.join(job["tmp"], f"{name}.r{r}.npz")))
            for r in range(job["world"])]


# ----------------------------------------------------------------------
# GPipe over stages
def _jax_pipe(z, n_stage, micro):
    plan = make_mesh(f"cpu:0-{n_stage - 1}", model_parallel=n_stage)
    w_out = jnp.asarray(z["w_out"])

    def loss(p, x):
        o = jpipeline.pipeline_apply(
            lambda q, h: jax.nn.relu(h @ q["w"] + q["b"]), p, x, plan.mesh,
            n_microbatch=micro)
        return jnp.sum(o * w_out), o

    (_, o), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
        {n: jnp.asarray(z[n]) for n in ("w", "b")}, jnp.asarray(z["x"]))
    return np.asarray(o), np.asarray(gx), {n: np.asarray(g)
                                           for n, g in gp.items()}


@pytest.mark.parametrize("which", ["job2", "job4"])
def test_gpipe_matches_jax_shard_map(which, request):
    job = request.getfixturevalue(which)
    z = np.load(os.path.join(job["tmp"], "gpipe.npz"))
    n_stage = job["stages"]
    want_o, want_dx, want_g = _jax_pipe(z, n_stage, job["micro"])
    per = z["w"].shape[0] // n_stage
    for r, got in enumerate(_load(job, "gpipe")):
        stage = r % n_stage
        np.testing.assert_allclose(got["o"], want_o, rtol=0, atol=PIPE_ATOL)
        np.testing.assert_allclose(got["dx"], want_dx, rtol=0,
                                   atol=PIPE_ATOL)
        for n in ("w", "b"):
            np.testing.assert_allclose(
                got[f"d{n}"], want_g[n][stage * per:(stage + 1) * per],
                rtol=0, atol=PIPE_ATOL, err_msg=f"rank {r} d{n}")


# ----------------------------------------------------------------------
# the nets over the model axis
def _jax_run(name, job):
    jt = JaxTrainer()
    dev = f"cpu:0-{job['world'] - 1}"
    jt.set_params([(k, dev if k == "dev" else v)
                   for k, v in _pairs(name, job["batch"])]
                  + [("model_parallel", "2")])
    jt.load_model(os.path.join(job["tmp"], f"{name}_init.model"))
    assert jt.mesh_plan.n_model == 2
    b = np.load(os.path.join(job["tmp"], f"{name}.npz"))
    for k in range(STEPS):
        jt.update(JaxBatch(data=b["data"][k], label=b["label"][k]))
    return jt


def _shard_shape(a):
    return tuple(a.sharding.shard_shape(a.shape))


def _check_net(job, name):
    from cxxnet_tpu.parallel.distributed import fetch_array

    jt = _jax_run(name, job)
    got = _load(job, name)
    n = 0
    for key, tags in jt.params.items():
        for tag, w in tags.items():
            want = fetch_array(w)
            for r, g in enumerate(got):
                np.testing.assert_allclose(
                    g[f"p:{key}/{tag}"], want, rtol=NET_RTOL, atol=NET_ATOL,
                    err_msg=f"{name} rank {r} {key}/{tag}")
                assert g[f"s:{key}/{tag}"].shape == _shard_shape(w), (
                    name, key, tag)
            n += 1
    assert n == sum(k.startswith("p:") for k in got[0])
    for key, tags in jt.ustates.items():
        for tag, slots in tags.items():
            for slot, v in slots.items():
                assert got[0][f"u:{key}/{tag}@{slot}"].shape == \
                    _shard_shape(v), (name, key, tag, slot)
    for g in got[1:]:  # every rank holds the same loss
        np.testing.assert_array_equal(g["losses"], got[0]["losses"])
    return jt, got


@pytest.mark.parametrize("name", ["incep", "moe", "pipe", "tf"])
def test_nets_on_one_by_two_match_jax(job2, name):
    jt, got = _check_net(job2, name)
    if name == "moe":  # every tensor cut: half the state a rank
        assert 2 * int(got[0]["shard_bytes"]) == int(got[0]["total_bytes"])
    if name in ("pipe", "tf"):  # one stage a rank
        key = "l0_pp" if name == "pipe" else "l0_blocks"
        tag = "wmat" if name == "pipe" else "wqkv"
        assert got[0][f"s:{key}/{tag}"].shape[0] == 2


@pytest.mark.parametrize("name", ["tf_lars", "moe_lamb"])
def test_whole_norm_updaters_on_one_by_two_match_jax(job2, name):
    _jt, got = _check_net(job2, name)
    cut = "s:l0_blocks/wqkv" if name == "tf_lars" else "s:l0_mx/wmat"
    assert got[0][cut].shape[0] == 2  # one stage, or two experts, a rank


@pytest.mark.parametrize("name", ["zero", "zero3", "tf", "pipe", "moe"])
def test_nets_on_two_by_two_match_jax(job4, name):
    _jt, got = _check_net(job4, name)
    if name == "zero3":  # the data indices hold other slices
        return
    for r in range(2, 4):  # each slice against its replica on data index 0
        for key, w in got[r].items():
            if key.startswith("s:"):
                assert w.tobytes() == got[r - 2][key].tobytes(), (r, key)


# ----------------------------------------------------------------------
# checkpoints, weights and the integrity plane
def test_checkpoint_from_two_model_ranks_loads_anywhere(job2):
    got = _load(job2, "incep")
    assert str(got[0]["save_error"])  # a path rank 0 cannot write
    one = NetTrainer()
    one.set_params(_pairs("incep", 8))
    one.load_model(job2["save"])
    jt = JaxTrainer()
    jt.set_params(_pairs("incep", 8))
    jt.load_model(job2["save"])
    n = 0
    for key, tags in one.params.items():
        for tag, w in tags.items():
            want = got[0][f"p:{key}/{tag}"]
            assert w.numpy().tobytes() == want.tobytes(), (key, tag)
            assert np.asarray(jt.params[key][tag]).tobytes() == \
                want.tobytes(), (key, tag)
            n += 1
    assert n == 16
    # the rank-0 checkpoint bytes of the run: the same arrays
    again = NetTrainer()
    again.set_params(_pairs("incep", 8))
    again.load_model(os.path.join(job2["tmp"], "incep.model"))
    for key, tags in again.params.items():
        for tag, w in tags.items():
            assert w.numpy().tobytes() == \
                got[0][f"p:{key}/{tag}"].tobytes()


def test_copy_model_from_slices_a_jax_checkpoint(job2):
    """``copy_model_from`` over the model axis: each rank keeps its slice
    of every copied layer; gathered, the JAX checkpoint's arrays."""
    jt = JaxTrainer()
    jt.set_params(_pairs("incep", 8))
    jt.load_model(os.path.join(job2["tmp"], "incep_init.model"))
    got = _load(job2, "finetune")
    for key, tags in jt.params.items():
        for tag, w in tags.items():
            want = np.asarray(w)
            for g in got:
                assert g[f"p:{key}/{tag}"].tobytes() == want.tobytes()
            whole = np.concatenate(
                [g[f"s:{key}/{tag}"] for g in got], axis=3 if want.ndim == 4
                else 0) if got[0][f"s:{key}/{tag}"].shape != want.shape \
                else got[0][f"s:{key}/{tag}"]
            assert whole.tobytes() == want.tobytes(), (key, tag)


def test_get_and_set_weight_over_the_model_axis(job2):
    jt = _jax_run("incep", job2)
    got = _load(job2, "incep")
    names = {f"{layer}/{tag}" for layer, tag in WEIGHTS}
    keys = {}
    for layer, tag in WEIGHTS:
        want = jt.get_weight(layer, tag)
        key = next(k for k in jt.params if k.endswith(f"_{layer}"))
        keys[f"{key}/{tag}"] = f"{layer}/{tag}"
        for g in got:
            np.testing.assert_allclose(g[f"gw:{layer}/{tag}"], want,
                                       rtol=NET_RTOL, atol=NET_ATOL)
    assert set(keys.values()) == names
    for g in got:
        for name, w in g.items():
            if not name.startswith("sw:"):
                continue
            before = g["p:" + name[3:]]
            scale = 2 if name[3:] in keys else 1
            assert w.tobytes() == (scale * before).tobytes(), name


def test_integrity_slices_combine_into_jax_digest(job2):
    got = _load(job2, "incep")
    parts = {}
    for r, g in enumerate(got):
        for name, d in g.items():
            if name.startswith("fp:"):
                leaf, sk = name[3:].split("|", 1)
                parts.setdefault(leaf, {}).setdefault(sk, set()).add(
                    tuple(int(v) for v in d))
    cut = {"l0_r3/wmat", "l12_fc/wmat", "l3_c3/wmat", "l4_bn/wmat"}
    assert cut <= {leaf for leaf, sks in parts.items() if len(sks) == 2}
    assert len(parts["l9_p2/wmat"]) == 1  # 3 channels: whole
    for leaf, sks in parts.items():
        digests = []
        for ds in sks.values():
            assert len(ds) == 1, leaf  # the replicas of a slice agree
            digests.extend(ds)
        s1 = sum(d[0] for d in digests) & 0xFFFFFFFF
        s2 = sum(d[1] for d in digests) & 0xFFFFFFFF
        assert (s1, s2) == digest_global(jnp.asarray(
            got[0][f"p:{leaf}"])), leaf


# ----------------------------------------------------------------------
# in one process: the placement rules and the stage checks
SHAPES = [(), (7,), (8,), (6, 4), (3, 3, 5, 12), (3, 3, 16, 16), (5, 7),
          (10, 12, 4), (4, 48, 16)]
MESHES = [(1, 2), (2, 2), (1, 4)]


def _plans(n_data, n_model):
    jplan = make_mesh(f"cpu:0-{n_data * n_model - 1}",
                      model_parallel=n_model)
    tplan = tmesh.MeshPlan(device=torch.device("cpu"), n_data=n_data,
                           n_model=n_model)
    return jplan, tplan


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("shape", SHAPES)
def test_model_dim_is_jax_param_sharding(mesh, shape):
    jplan, tplan = _plans(*mesh)
    spec = list(jplan.param_sharding(shape).spec)
    assert tplan.model_dim(shape) == (spec.index("model") if "model" in spec
                                      else None)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("shape", SHAPES)
def test_owner_dim_is_jax_state_sharding_over_the_model_axis(mesh, shape):
    jplan, tplan = _plans(*mesh)
    spec = list(jplan.state_sharding(shape).spec)
    assert tplan.owner_dim(shape) == (spec.index("data") if "data" in spec
                                      else None)


@pytest.mark.parametrize("kind,shape", [
    ("pipe_mlp", (8, 16)), ("pipe_mlp", (6, 16)),
    ("pipe_transformer", (8, 4, 16)), ("pipe_transformer", (6, 4, 16))])
@pytest.mark.parametrize("nblock", [3, 4])
def test_stage_checks_are_jax_s(kind, shape, nblock):
    msgs = []
    for make in (create_layer, jax_layer):
        lay = make(kind)
        for k, v in (("nblock", nblock), ("pipeline_parallel", 1),
                     ("n_microbatch", 4), ("nhead", 2)):
            lay.set_param(k, str(v))
        lay.bind_mesh(types.SimpleNamespace(n_model=2))
        try:
            lay.infer_shape([shape])
            msgs.append("ok")
        except ValueError as e:
            msgs.append(str(e))
    assert msgs[0] == msgs[1]
    assert (msgs[0] == "ok") == (nblock == 4 and shape[0] == 8)
