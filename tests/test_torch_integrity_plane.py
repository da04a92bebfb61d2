"""The port's integrity plane (``cxxnet_tpu_torch/integrity/``) against
the JAX package's, on the CPU.

* ``digest_array`` is the JAX oracle, bit for bit, over f32, bf16, f16,
  int8, uint8 and int32 arrays, whole and as blocks of a logical tensor
  whose global word index passes 2^31 and 2^32 (a slice of a huge
  shape, not a huge array); ``digest_tensor`` on the CPU gives the same
  two words.  No tolerance: the digests are integers.
* ``vote`` gives the JAX findings on the same replica groups.
* ``inject_bitflip`` with one seed flips the same leaf, element and bit
  as the JAX trainer's, in place: the element differs from its old value
  in exactly that bit, and the leaf's digest changes.
* ``shadow_step`` is clean on a small net (the two legs bitwise equal),
  and a one-shot ``inject_shadow_mismatch`` is reported as the JAX
  trainer reports it (``tensor = "loss"``).
* The CLI with ``integrity_every = 1`` logs ``integrity.clean`` a round
  and writes the ``integrity`` telemetry block; a ``device.state``
  bitflip leaves the single-replica vote clean (as in JAX on one
  process); ``inject_shadow_mismatch = 1`` stops the run with
  ``IntegrityError`` of kind ``shadow`` and the round is not saved.
"""

import json
import os
import random

import ml_dtypes
import numpy as np
import pytest
import torch

from cxxnet_tpu import config as jcfg
from cxxnet_tpu.integrity import fingerprint as jfp
from cxxnet_tpu.integrity import plane as jplane
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer

from cxxnet_tpu_torch import config as tcfg
from cxxnet_tpu_torch.cli import LearnTask
from cxxnet_tpu_torch.integrity import IntegrityError, IntegrityPlane
from cxxnet_tpu_torch.integrity import fingerprint as tfp
from cxxnet_tpu_torch.integrity import plane as tplane
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.obs import events as tevents

NET = """
netconfig = start
layer[0->1] = conv:c1
  kernel_size = 3
  pad = 1
  nchannel = 4
  init_sigma = 0.2
layer[1->2] = max_pooling
  kernel_size = 3
  stride = 2
layer[2->3] = lrn
  local_size = 3
layer[3->4] = flatten
layer[4->4] = dropout
  threshold = 0.3
layer[4->5] = fullc:fc
  nhidden = 3
  init_sigma = 0.2
layer[5->5] = softmax
netconfig = end
input_shape = 3,6,6
batch_size = 4
updater = sgd
eta = 0.05
momentum = 0.9
dev = cpu
seed = 7
"""


@pytest.fixture(autouse=True, scope="module")
def _jax_obs_registry_as_found():
    """As in ``test_torch_train.py``: drop the empty device-plane
    histogram the JAX trainer registers, which an exposition check later
    in the same process (``tests/test_obs.py``) rejects."""
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


DTYPES = {"f32": np.float32, "bf16": ml_dtypes.bfloat16, "f16": np.float16,
          "int8": np.int8, "uint8": np.uint8, "int32": np.int32}


def _array(dt, shape, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape) * 1000
    if dt in ("int8", "uint8"):
        x = rng.randint(0, 256, size=shape)
    elif dt == "int32":
        x = rng.randint(-2 ** 31, 2 ** 31 - 1, size=shape, dtype=np.int64)
    return x.astype(DTYPES[dt])


def _tensor(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


# (block shape, index, logical shape): the last two reach global word
# indices past 2^31 and 2^32
BLOCKS = [
    ((5, 7), None, None),
    ((3, 4, 5), (slice(2, 5), slice(0, 4), slice(0, 5)), (9, 4, 5)),
    ((2, 3), (slice(70000, 70002), slice(40000, 40003)), (80000, 40000)),
    ((2, 3), (slice(1 << 20, (1 << 20) + 2), slice(5000, 5003)),
     ((1 << 20) + 8, 1 << 13)),
]


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("block", range(len(BLOCKS)))
def test_digests_are_the_jax_words(dt, block):
    shape, index, logical = BLOCKS[block]
    a = _array(dt, shape, block + 1)
    want = jfp.digest_array(a, index=index, shape=logical)
    assert tfp.digest_array(a, index=index, shape=logical) == want
    assert tfp.digest_tensor(_tensor(a), index=index, shape=logical) == want
    if index is not None:
        starts = [s.start for s in index]
        gi_max = sum(st * int(np.prod(logical[d + 1:]))
                     for d, st in enumerate(starts))
        assert block < 2 or gi_max > 2 ** 31
    flipped = a.copy()
    flipped.reshape(-1).view(f"u{a.dtype.itemsize}")[1] ^= 1
    assert tfp.digest_tensor(_tensor(flipped), index=index,
                             shape=logical) != want


def test_digest_of_a_strided_view_is_its_contents():
    t = torch.arange(60, dtype=torch.float32).reshape(6, 10)[:, ::3]
    assert tfp.digest_tensor(t) == jfp.digest_array(t.numpy())
    assert tfp.combine_digests([(1, 2), (0xFFFFFFFF, 5)]) == \
        jfp.combine_digests([(1, 2), (0xFFFFFFFF, 5)])


GROUPS = [
    {("w", ((0, 4, None),)): [(0, (1, 2)), (1, (1, 2)), (2, (1, 2))]},
    {("w", ()): [(0, (1, 2)), (1, (9, 2)), (2, (1, 2))],
     ("b", ()): [(0, (3, 3)), (1, (3, 3))]},
    {("w", ()): [(0, (1, 2)), (1, (9, 2))]},
    {("w", ()): [(0, (1, 2)), (1, (9, 2)), (2, (7, 2)), (3, (1, 2))]},
    {("w", ()): [(0, (5, 5))], ("v", ()): [(0, (1, 1)), (1, (2, 2)),
                                            (2, (2, 2)), (3, (2, 2))]},
]


@pytest.mark.parametrize("g", range(len(GROUPS)))
def test_vote_gives_the_jax_findings(g):
    assert tplane.vote(GROUPS[g]) == jplane.vote(GROUPS[g])


def _trainers(tmp_path):
    tr = NetTrainer()
    tr.set_params(tcfg.parse_pairs(NET))
    tr.init_model()
    path = str(tmp_path / "0000.model")
    tr.save_model(path, round_=0)
    jt = JaxTrainer()
    jt.set_params(jcfg.parse_pairs(NET))
    jt.load_model(path)
    return tr, jt


@pytest.mark.parametrize("seed", [0, 11, 12345])
def test_bitflip_flips_the_jax_leaf_element_and_bit(tmp_path, seed):
    tr, jt = _trainers(tmp_path)
    before = {f"{k}/{t}": w.clone() for k, tags in tr.params.items()
              for t, w in tags.items()}
    jd = jt.inject_bitflip(random.Random(seed))
    td = tr.inject_bitflip(random.Random(seed))
    assert (td["tensor"], td["elem"], td["bit"]) == \
        (jd["tensor"], jd["elem"], jd["bit"])
    key, tag = td["tensor"].split("/")
    old = before[td["tensor"]].reshape(-1).view(torch.int32)
    new = tr.params[key][tag].reshape(-1).view(torch.int32)
    diff = (old ^ new).nonzero().reshape(-1).tolist()
    assert diff == [td["elem"]]
    assert int(old[td["elem"]] ^ new[td["elem"]]) & 0xFFFFFFFF == \
        1 << td["bit"]
    assert tfp.digest_tensor(tr.params[key][tag]) != tfp.digest_tensor(
        before[td["tensor"]])
    assert tfp.digest_tensor(tr.params[key][tag]) == tfp.digest_array(
        tr.params[key][tag].numpy())
    # one process: single-replica groups, the vote stays clean
    assert tplane.check_state(tr)["clean"]


def test_shadow_step_is_clean_and_reports_a_mismatch(tmp_path):
    tr, jt = _trainers(tmp_path)
    assert tr.shadow_step(3) is None
    before = {k: {t: w.clone() for t, w in tags.items()}
              for k, tags in tr.params.items()}
    tr.set_param("inject_shadow_mismatch", "1")
    jt.set_param("inject_shadow_mismatch", "1")
    got, want = tr.shadow_step(4), jt.shadow_step(4)
    assert got["tensor"] == want["tensor"] == "loss"
    assert got["detail"].split(":")[0] == want["detail"].split(":")[0]
    assert tr.shadow_step(4) is None  # one-shot
    for k, tags in tr.params.items():  # the audit changes nothing
        for t, w in tags.items():
            assert torch.equal(w, before[k][t])
    assert torch.backends.cudnn.deterministic is False


def test_plane_counts_and_snapshots(tmp_path):
    tr, _ = _trainers(tmp_path)
    p = IntegrityPlane(every=2, shadow=1)
    assert [p.due(r) for r in range(4)] == [False, True, False, True]
    assert p.check_round(tr, 0) is None
    v = p.check_round(tr, 1)
    assert v["clean"] and v["replicas"] == 1
    assert p.snapshot()["checks"] == 1 and p.last_clean_round == 1
    tr.set_param("inject_shadow_mismatch", "1")
    with pytest.raises(IntegrityError) as ei:
        p.check_round(tr, 3)
    assert ei.value.kind == "shadow" and ei.value.tensor == "loss"
    assert tevents.recent(3, kind="integrity.detect")


TRAIN = """
data = train
iter = synthetic
  nsample = 16
  input_shape = 3,6,6
  nclass = 3
iter = end
""" + NET + """
integrity_every = 1
integrity_shadow = 1
save_ustate = 1
"""


def _cli(tmp_path, *extra):
    conf = tmp_path / "t.conf"
    conf.write_text(TRAIN)
    mdir = tmp_path / "m"
    argv = [str(conf), f"model_dir={mdir}", "num_round=2", "silent=1",
            f"telemetry_path={tmp_path / 'tel.jsonl'}", "telemetry=1",
            *extra]
    return LearnTask().run(argv), mdir


def test_cli_checks_each_round_and_a_bitflip_votes_clean(tmp_path):
    tevents.event_log().reset()
    rc, mdir = _cli(tmp_path, "fault_seed=4",
                    "fault_inject=device.state:bitflip:1:1")
    assert rc == 0
    assert (mdir / "0002.model").exists()
    clean = tevents.recent(20, kind="integrity.clean")
    assert [e["round"] for e in clean] == [0, 1]
    assert tevents.recent(20, kind="fault.injected")
    recs = [json.loads(x) for x in
            (tmp_path / "tel.jsonl").read_text().splitlines()]
    assert [r["integrity"]["checks"] for r in recs] == [0, 1]
    assert recs[-1]["integrity"]["every"] == 1


def test_cli_stops_on_a_shadow_mismatch_without_saving(tmp_path, capsys):
    with pytest.raises(IntegrityError) as ei:
        _cli(tmp_path, "inject_shadow_mismatch=1")
    assert ei.value.kind == "shadow"
    assert "INTEGRITY: integrity shadow check failed at round 0" in \
        capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "m")) == [
        "0000.model", "0000.model.manifest.json"]
