"""Data parallelism's conf surface and rules, in one process, against
the JAX package on the CPU.

* The parallel keys (``zero``, ``fsdp``, ``shard_weight_update``,
  ``update_on_server``, ``det_reduce``, ``async_overlap``,
  ``async_groups``, ``staleness``, ``async_resync_period``) accept and
  refuse what the JAX ``NetTrainer`` does, with its messages, at
  ``set_param`` and at ``init_model`` on one device.  Over two ranks the
  port refuses ``det_reduce`` where the JAX package refuses it on two
  devices (same message), and arms ``async_overlap = 1`` (ROADMAP.md
  item (k3)).  The rank count comes from a patched ``process_info``: the
  refusals come before any collective.
* ``parse_device`` equals the JAX parser (ranges, lists, the messages of
  a reversed range and an empty list); ``gpu:k`` is the card ``k``, and
  an ordinal past the cards raises the JAX message; ranks take their
  devices by the rule of ``parallel/mesh.py``; the backend rule.
* ``MeshPlan.owner_dim`` cuts the dimension the JAX ``state_sharding``
  shards over the data axis, at 2 and 4 ranks.
* The worker shards of ``iter = synthetic`` and ``iter = csv`` equal
  the JAX iterators' batches at every rank (mnist, imgbin and img:
  ``tests/test_torch_mnist.py``, ``tests/test_torch_imgbin.py``; text:
  ``tests/test_torch_lm.py``).
"""

import os

import numpy as np
import pytest
import torch

from cxxnet_tpu import config as jcfg
from cxxnet_tpu.io import data as jdata
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
from cxxnet_tpu.parallel import mesh as jmesh

from cxxnet_tpu_torch import config as tcfg
from cxxnet_tpu_torch.io import data as tdata
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.parallel import distributed as pdist
from cxxnet_tpu_torch.parallel import mesh as tmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NET = """
netconfig = start
layer[0->1] = fullc:fc1
  nhidden = 6
  init_sigma = 0.1
layer[1->1] = relu
layer[1->2] = fullc:fc2
  nhidden = 3
  init_sigma = 0.1
layer[2->2] = softmax
netconfig = end
input_shape = 1,1,8
batch_size = 4
seed = 1
"""

# (key, value, extra keys): accepted or refused alike in both packages
KEYS = [
    ("zero", "0", ()), ("zero", "1", ()), ("zero", "2", ()),
    ("zero", "3", ()), ("zero", "4", ()), ("fsdp", "1", ()),
    ("fsdp", "2", ()), ("shard_weight_update", "1", ()),
    ("shard_weight_update", "3", ()), ("update_on_server", "1", ()),
    ("det_reduce", "1", ()), ("det_reduce", "2", ()),
    ("async_overlap", "1", ()), ("async_overlap", "2", ()),
    ("async_groups", "-1", ()), ("async_groups", "4", ()),
    ("staleness", "-1", ()), ("staleness", "1", ()),
    ("staleness", "1", (("async_overlap", "1"),)),
    ("async_resync_period", "0", ()), ("async_resync_period", "2", ()),
]


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


def _outcome(make, pairs):
    """``("ok", "")`` or ``(exception type name, message)`` of setting
    ``pairs`` on a fresh trainer and building its model."""
    tr = make()
    try:
        tr.set_params(pairs)
        tr.init_model()
    except (ValueError, NotImplementedError) as e:
        return type(e).__name__, str(e)
    return "ok", ""


@pytest.mark.parametrize("key,val,extra", KEYS)
def test_parallel_keys_accept_and_refuse_as_jax(key, val, extra):
    tail = [(key, val), *extra]
    jax_out = _outcome(JaxTrainer,
                       jcfg.parse_pairs(NET + "dev = cpu\n") + tail)
    port_out = _outcome(NetTrainer,
                        tcfg.parse_pairs(NET + "dev = cpu\n") + tail)
    assert port_out == jax_out


BN_DROP = NET.replace("layer[1->1] = relu", """layer[1->1] = batch_norm:bn
  bn_eval = running
layer[1->1] = dropout
  threshold = 0.5""")


@pytest.mark.parametrize("keys", [
    (("det_reduce", "1"),),
    (("det_reduce", "1"), ("update_period", "2")),
    (("det_reduce", "1"), ("zero", "1")),
])
def test_det_reduce_refusals_over_two_ranks_are_jax_s(monkeypatch, keys):
    jax_out = _outcome(JaxTrainer,
                       jcfg.parse_pairs(BN_DROP + "dev = cpu:0-1\n")
                       + list(keys))
    monkeypatch.setattr(pdist, "process_info", lambda: (0, 2))
    port_out = _outcome(NetTrainer,
                        tcfg.parse_pairs(BN_DROP + "dev = cpu\n")
                        + list(keys))
    assert jax_out[0] == "ValueError" and "det_reduce=1" in jax_out[1]
    assert port_out == jax_out


def test_async_overlap_over_two_ranks_is_k3(monkeypatch):
    """(k3) is ported: over two ranks the model builds with the async
    step armed (its refusals and steps: tests/test_torch_async_ps.py)."""
    monkeypatch.setattr(pdist, "process_info", lambda: (0, 2))
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(NET + "dev = cpu\n")
                  + [("async_overlap", "1")])
    tr.init_model()
    assert tr._async_active()
    # one rank: the documented no-op, as in the JAX package
    monkeypatch.setattr(pdist, "process_info", lambda: (0, 1))
    assert _outcome(NetTrainer, tcfg.parse_pairs(NET + "dev = cpu\n")
                    + [("async_overlap", "1")]) == ("ok", "")


@pytest.mark.parametrize("dev", [
    "tpu", "gpu", "tpu:0-3", "gpu:0,2,5", "cpu:1-2, 4", "tpu:3",
    "tpu:3-1", "tpu:", "gpu:,"])
def test_parse_device_is_the_jax_parser(dev):
    def run(fn):
        try:
            return fn(dev)
        except ValueError as e:
            return str(e)

    assert run(tmesh.parse_device) == run(jmesh.parse_device)


def test_gpu_k_is_card_k(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    for dev, want in (("gpu:1", "cuda:1"), ("cuda:7", "cuda:7"),
                      ("tpu", "cuda:0"), ("GPU:3", "cuda:3")):
        assert tmesh.rank_device(dev) == torch.device(want)
    # past the cards: the JAX package's message (its pool: 8 devices)
    with pytest.raises(ValueError) as je:
        jmesh.make_mesh("tpu:9")
    with pytest.raises(ValueError) as te:
        tmesh.rank_device("tpu:9")
    assert str(te.value) == str(je.value)
    # one card: card 1 does not exist (the parent ran it on card 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"ordinals \[1\] but only 1"):
        tmesh.rank_device("gpu:1")


def test_ranks_take_their_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert [str(tmesh.rank_device("gpu:0-1", r, 2)) for r in (0, 1)] == [
        "cuda:0", "cuda:1"]
    assert [str(tmesh.rank_device("gpu:0", r, 2)) for r in (0, 1)] == [
        "cuda:0", "cuda:0"]  # two ranks may share a card (gloo)
    assert [str(tmesh.rank_device("gpu", r, 4)) for r in range(4)] == [
        "cuda:0", "cuda:1", "cuda:0", "cuda:1"]
    assert tmesh.rank_device("cpu:0-2", 2, 3) == torch.device("cpu")
    with pytest.raises(ValueError, match="3 devices for 2 processes"):
        tmesh.rank_device("gpu:0-2", 0, 2)
    with pytest.raises(NotImplementedError, match="dist_num_proc"):
        tmesh.rank_device("cpu:0-1")


@pytest.mark.parametrize("devices,want", [
    (["cpu", "cpu"], "gloo"), (["cuda:0", "cuda:0"], "gloo"),
    (["cuda:0", "cuda:1"], "nccl"), (["cuda:0", "cpu"], "gloo"),
    (["cuda:0", "cuda:1", "cuda:1"], "gloo")])
def test_backend_rule(devices, want):
    assert pdist.backend_for(devices) == want


SHAPES = [(), (7,), (8,), (6, 4), (3, 3, 5, 12), (3, 3, 16, 16), (5, 7),
          (10, 12, 4), (1024, 832)]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("shape", SHAPES)
def test_owner_dim_is_jax_state_sharding(n, shape):
    plan = jmesh.make_mesh(f"cpu:0-{n - 1}")
    spec = list(plan.state_sharding(shape).spec)
    want = spec.index("data") if "data" in spec else None
    got = tmesh.MeshPlan(device=torch.device("cpu"), n_data=n).owner_dim(
        shape)
    assert got == want


def _batches(it):
    it.before_first()
    out = []
    while it.next():
        v = it.value()
        out.append((np.array(v.data), np.array(v.label)))
    return out


def _same_batches(entries):
    a, b = jdata.create_iterator(entries), tdata.create_iterator(entries)
    a.init()
    b.init()
    assert b.supports_dist_shard()
    ja, tb = _batches(a), _batches(b)
    assert len(ja) == len(tb) > 0
    for (d0, l0), (d1, l1) in zip(ja, tb):
        assert d0.tobytes() == d1.tobytes() and l0.tobytes() == l1.tobytes()
    return tb


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_synthetic_worker_shards_are_jax_s(rank):
    got = _same_batches([
        ("iter", "synthetic"), ("nsample", "24"), ("input_shape", "1,1,5"),
        ("nclass", "3"), ("seed_data", "2"), ("dist_num_worker", "3"),
        ("dist_worker_rank", str(rank)), ("iter", "end"),
        ("batch_size", "4")])
    assert len(got) == 6


@pytest.mark.parametrize("rank", [0, 1])
def test_csv_worker_shards_are_jax_s(tmp_path, rank):
    rows = np.random.RandomState(3).randint(0, 9, (11, 7))
    path = tmp_path / "d.csv"
    path.write_text("\n".join(",".join(str(v) for v in r) for r in rows))
    got = _same_batches([
        ("iter", "csv"), ("filename", str(path)), ("label_width", "1"),
        ("input_shape", "1,1,6"), ("dist_num_worker", "2"),
        ("dist_worker_rank", str(rank)), ("silent", "1"), ("iter", "end"),
        ("input_shape", "1,1,6"), ("batch_size", "2"), ("round_batch", "0")])
    assert len(got) == 3  # 5 rows each: the last batch padded


@pytest.mark.parametrize("mod", ["parallel/__init__.py", "parallel/mesh.py",
                                 "parallel/distributed.py"])
def test_parallel_modules_sit_at_the_jax_path(mod):
    assert os.path.exists(os.path.join(REPO, "cxxnet_tpu", mod))
    assert os.path.exists(os.path.join(REPO, "cxxnet_tpu_torch", mod))
