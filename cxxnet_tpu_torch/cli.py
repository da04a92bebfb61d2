"""Command-line entry point: ``python -m cxxnet_tpu_torch <conf> [name=val ...]``.

Counterpart of ``cxxnet_tpu/cli.py`` for ``task=train``, ``finetune``,
``pred``, ``pred_raw``, ``extract``, ``summary``, ``serve``,
``generate``, ``export_quant``, ``serve_train``, ``loop_fleet`` and
``data_service``.  The conf (plus ``name=value``
overrides, applied after the file's entries) is parsed with the same
grammar.

``task=train``: a fresh model (``model_in = NULL``, written as
``0000.model`` before the first round), the model of ``model_in``, or
with ``continue = 1`` the newest valid checkpoint in ``model_dir``; then
rounds until ``num_round`` (at most ``max_round`` in this run).  A round
runs one step per batch of the ``data`` section, prints ``update round
N`` and a rate line, writes ``[N]\tname-metric:value`` evaluation lines
(train metrics, then every ``eval`` section) to stderr, and saves
``%04d.model`` every ``save_model`` rounds.  SIGTERM/SIGINT finish the
current batch, snapshot and exit 0.  ``scan_steps = N`` (a device
program of N steps in the JAX package) runs N single steps here, which
is the same math.  ``save_ustate = 1`` writes the updater state into
each checkpoint, so ``continue = 1`` (or ``model_in``) resumes exactly.
``integrity_probe = 1`` commits the serving canary's probe batch and its
golden score CRC into each checkpoint's manifest (``probe``).
``divergence_policy = abort|rollback`` arms the trainer's loss guard
(``divergence_loss_ratio`` adds the finite spike gate): ``abort`` stops
the run on a trip (``DIVERGENCE: ...``, a non-zero exit); ``rollback``
reloads the newest valid checkpoint whose weights are finite, multiplies
the learning rates by ``divergence_lr_backoff`` (0.5) once more, and
runs the round again, at most ``divergence_max_retries`` (3) times in a
row.
``example/ImageNet/resnet{50,101,152}.conf`` train as they stand
(``batch_norm`` with ``bn_stats`` / ``bn_eval`` / ``bn_momentum``, the
``synthetic`` sections, ``metric = rec@1`` / ``rec@5``), and so do the
``iter = mnist`` confs of ``example/MNIST`` once their idx files exist,
and the ``iter = imgbin`` confs of ``example/ImageNet`` and
``example/kaggle_bowl`` once their pages exist (raw-pixel pages where
PIL is missing); ``dev = tpu`` means the card.  ``update_period = N``
applies the updaters once per N batches, to their summed gradients.
Each round anchors the data chain's augmentation epoch to the round
counter before it rewinds (``augment_epoch_next``), so a resumed round
draws the augmentation an uninterrupted run draws, with or without
``threadbuffer``.  ``fault_inject`` / ``fault_seed`` arm the fault sites
of the data chain (``utils/faults.py``) for every task.

Every task arms the observability plane (``obs/``) from the conf at
startup: ``event_log`` writes the lifecycle events (``train.start``,
``train.end``, ``train.preempted``, ``checkpoint.restore``,
``checkpoint.save``, ``divergence.trip``, ``divergence.rollback``, the
serving and data events), ``trace_dir`` / ``trace_steps`` write the
host spans of the first steps (``train.round``, ``train.dispatch`` a
step, ``train.device_wait`` at the round's end, ``checkpoint.write``)
as Chrome trace JSON, ``device_sample_every = N`` times every Nth
update's wait for the card into ``train_step_device_seconds``, and
``alert = name:metric:op:threshold[:for_s]`` rules are evaluated every
``alert_period_s`` (``/alertz``, ``/healthz`` under ``task=serve``).

``task=finetune``: as ``train``, from a fresh init into which every
layer of ``model_in`` (a checkpoint of either package) whose name and
tag shapes match is copied (``Copying layer <name>``); the round counter
starts at 0.

``task=pred`` / ``pred_raw`` / ``extract`` run the model of
``model_in`` over the iterator of the conf's ``pred = <file>`` section
and write ``<file>``: ``pred`` one prediction a line (``{v:g}``),
``pred_raw`` each output row space-separated with a trailing ``" \n"``,
``extract`` the features of node ``extract_node_name`` as txt rows
(the default) or ``<f4`` binary (``output_format = bin``), plus a
``<file>.meta`` line ``n,d0,d1,d2``.  ``task=summary`` prints the
layer table (type, name, output shape, parameters) of the conf's net,
or of ``model_in``'s.  These tasks build no ``data`` or ``eval``
iterator (``extract`` builds them, as the JAX package does).

``task=serve``: a checkpoint is loaded from ``model_in`` (or the newest
valid one in ``model_dir``) into an
:class:`~cxxnet_tpu_torch.serve.Engine`, and the JSON endpoint serves on
``serve_host:serve_port`` (``serve_port = 0`` picks an ephemeral port,
printed on startup).  SIGTERM/SIGINT drain: the server stops accepting,
in-flight requests get up to ``drain_timeout_s`` to finish, queued ones
fail with 503, and the process exits 0.  ``serve_reload_period = S > 0``
polls ``model_dir`` every S seconds and hot-reloads a newer round
behind the reload breaker (``reload_breaker_threshold``,
``reload_breaker_cooldown_s``); ``POST /reloadz`` makes one attempt on
demand; ``integrity_probe = 1`` runs the golden canary on the same
period.

``task=serve`` with ``replicas = N >= 2``: the serving fleet
(``serve/fleet.py``, ``serve/router.py``).  N single-engine
``task=serve`` children (``python -m cxxnet_tpu_torch`` on this conf
and these overrides, the fleet keys pinned, each on its own free port,
its output in ``fleet_log_dir`` or ``<model_dir>/fleet_logs``) are
probed on ``/healthz``, restarted with backoff when they exit or wedge,
and served behind one front door on ``serve_host:serve_port``: priority
admission (``batch`` sheds first), least-loaded dispatch with failover,
one deadline budget for route and execute.  ``fleet: serving k/N
replica(s)`` is printed once the front door is bound.  With
``serve_reload_period > 0`` a newer round in ``model_dir`` rolls out one
replica at a time behind a fleet-level breaker; ``canary = int8
canary_replicas = k`` runs k replicas on the ``.quant.model`` sibling,
mirrors ``canary_sample`` of the baseline's traffic to them and promotes
or rolls back through the publish pointer (``PUBLISHED.json``).  A fleet
with no healthy replica after ``fleet_start_timeout_s`` raises (non-zero
exit); SIGTERM/SIGINT during the boot aborts it and reaps the children.

``task=generate``: samples ``gen_len`` bytes continuing ``gen_prompt``
(or the bytes of ``gen_prompt_file``, read only by this task) from the
byte-level language model of ``model_in`` (``nnet/generate.py``): the
KV-cache decode with ``gen_cache = 1`` (the default) where prompt and
output fit the training window, else the sliding window; ``gen_temp``
(0: greedy), ``gen_topk`` and ``gen_topp`` shape the sampling.  The
text goes to the ``pred`` section's file (default ``pred.txt``) and to
stdout.

``task=export_quant``: quantizes the f32 checkpoint ``model_in`` per
``quant`` (default int8), gates it on top-1 agreement with the f32 model
over the conf's first ``eval`` section (``quant_min_agreement``, default
0.99, 0 to skip the gate; ``quant_calib_batches``, 0 for the whole
section), falling layers back to bf16 until it passes, and writes
``<round>.quant.model`` beside the source (or ``quant_out``).  It prints
one JSON verdict line (also written to ``quant_report`` when set) and
exits 0 on publish, 3 on reject (nothing written).  ``task=serve
quant=int8`` then serves the artifact.

The round loop times each step with ``StepTimer`` on laps that tile
the round's wall time (the batch's fetch, the step and the wait for the
card) and prints the JAX package's lines: ``round N pipeline: decode
... | augment ... | batch ... | h2d ... | device_wait ...`` (the
per-stage breakdown of ``utils.profiler.pipeline_stats()``) and ``round
N: step X ms avg (p50 .., p99 ..), Y samples/sec``.  ``test_io = 1``
iterates the data section without training (``start I/O test``, then
the ``pipeline:`` line a round).  ``telemetry = 1`` appends one JSON
record a round to ``telemetry_path`` (``telemetry.jsonl``): ``ts``,
``round``, ``steps``, ``batches``, ``elapsed_s``, ``lr``, ``eval``,
``step``, ``stages``, ``device`` and, with the integrity plane,
``integrity``; a failed write is counted and logged once, and training
goes on.  ``profile = 1`` (``profile_dir``, ``profile_start``,
``profile_steps``) writes a ``torch.profiler`` Chrome trace of a window
of steps.  ``compile_cache_dir`` (any task) moves the kernel and host
build cache (``utils/compile_cache.py``).  ``integrity_every = N`` digests
and votes the train state every N rounds before the checkpoint, and
``integrity_shadow = 1`` adds the shadow-step audit; a failure prints
``INTEGRITY: ...`` and stops the run before the round is saved.  On one
process every vote group has one replica, so the vote is always clean
and a flipped bit in the state (``fault_inject = device.state:bitflip``)
is not detected, as in the JAX package; there only the shadow audit can
stop a run, and the sweep's cost buys detection once several processes
run (ROADMAP item A6).
``controller = 1`` runs the tuner (``tune/``): under ``task=train`` over
the decode pool's workers and window, under ``task=serve`` over the
batcher's limit and window, with the bucket prewarm each tick.

``task=serve_train``: the closed loop (``loop/``).  The engine serves
the newest valid round of ``model_dir`` as under ``task=serve``, with
``POST /feedback`` appending labelled rows to the feedback log under
``loop_dir`` (and, with ``capture_predict = 1``, every answered
``/predict`` logging its rows and predictions); a thread beside the
server runs the continuous loop: every ``loop_cycle_period_s`` it tails
the log and, with at least ``loop_min_records`` new records (at most
``loop_max_records`` a cycle), fine-tunes a fresh trainer loaded from
the served checkpoint for ``loop_rounds_per_cycle`` passes, each batch
padded with ``loop_replay_ratio`` rows of the ``data`` section, then
gates it on the first ``eval`` section against the serving model's
recorded metric (``publish_min_delta``, ``publish_metric``, the cohort
gate ``publish_slice_floor``): a pass is written as the next round with
``PUBLISHED.json`` and hot-reloaded, a reject rolls the trainer back.
``loop_max_cycles = N`` stops fine-tuning after N trained cycles
(serving goes on); ``feedback_retain_shards`` arms retention.  The tuner
runs as under ``task=serve``.  ``task=loop_fleet``: one engine, feedback
log and loop per ``tenant = <name>`` .. ``tenant = end`` section (each
with its own ``model_dir``) behind one server that routes by the
request's ``model``; one scheduler thread runs the tenants' cycles in
turn and sheds them all while an ``alert=`` rule fires.  Both refuse a
quantized model, ``replicas > 1`` and a conf with no ``eval`` section,
as the JAX package does, and drain on SIGTERM/SIGINT.

``task=data_service``: serves the conf's ``data`` section (decoded and
augmented once) as ``CXD1`` batch streams on
``data_service_host:data_service_port`` (``io/dataservice/``), with a
``/healthz``, ``/statsz``, ``/metricsz`` sidecar on
``data_service_http_port``, at most ``data_service_max_sessions``
clients, a ``data_service_cache_mb`` block cache and a
``data_service_window`` pipelining bound; the bound address goes to
``data_service_ready_file``.  A trainer reads it with ``iter = service``
and ``data_service_addr = host:port``.

The elastic and cross-process planes of training (``elastic``,
``elastic_join``, ``test_on_server``) are later slices (ROADMAP.md) and
raise ``NotImplementedError`` naming the item.
"""

from __future__ import annotations

import os
import signal
import sys
import threading
import time
from typing import List, Optional

from . import config as cfgmod

_TASKS = ("train", "finetune", "pred", "pred_raw", "extract", "summary",
          "serve", "generate", "export_quant", "serve_train", "loop_fleet",
          "data_service")
# train keys of planes this slice does not port: refused when switched on
_TRAIN_LATER = ("test_on_server", "elastic", "elastic_join")


class LearnTask:
    """The tasks of the JAX package's ``LearnTask`` (``_TASKS``)."""

    def __init__(self) -> None:
        self.task = "train"
        self.name_model_in = "NULL"
        self.name_model_dir = "models"
        self.num_round = 10
        self.max_round = 1 << 30
        self.start_counter = 0
        self.continue_training = 0
        self.save_period = 1
        self.divergence_policy = ""  # "" off | abort | rollback
        self.divergence_lr_backoff = 0.5
        self.divergence_max_retries = 3
        self._divergence_retries = 0
        self._lr_scale = 1.0
        self.integrity_probe = 0  # 1: commit the canary's probe at save
        self.integrity_every = 0  # rounds between votes; 0: off
        self.integrity_shadow = 0  # 1: the shadow-step audit at cadence
        self._integrity = None
        self.test_io = 0
        self.telemetry = 0  # per-round JSONL records
        self.telemetry_path = "telemetry.jsonl"
        self.controller = 0  # 1: the tuner (tune/)
        self._train_start = 0.0
        self.print_step = 100
        self.net_trainer = None
        self.itr_train = None
        self.itr_pred = None
        self.itr_evals: List = []
        self.eval_names: List[str] = []
        self.silent = 0
        self.serve_host = "127.0.0.1"
        self.serve_port = 9090
        self.serve_max_batch = 0  # 0: the trainer's batch_size
        self.batch_timeout_ms = 2.0
        self.queue_limit = 128
        self.serve_deadline_ms = 0.0
        self.drain_timeout_s = 5.0
        self.serve_reload_period = 0.0  # seconds; 0: no hot reload
        self.reload_breaker_threshold = 3
        self.reload_breaker_cooldown_s = 30.0
        self.watchdog_timeout_s = 600.0
        self.gen_prompt = ""
        self.gen_prompt_file = ""
        self.gen_len = 256
        self.gen_temp = 0.0
        self.gen_topk = 0
        self.gen_topp = 0.0
        self.gen_cache = 1
        self.quant = "int8"  # the export scheme (serving reads the raw key)
        self.quant_min_agreement = 0.99
        self.quant_calib_batches = 0  # 0: the whole eval section
        self.quant_out = ""
        self.quant_report = ""
        self.replicas = 1
        self.conf_path = ""
        self.cli_overrides: List[str] = []
        # the closed loop: the loop_*/publish_*/feedback_* defaults are
        # the one table task=loop_fleet's tenants read too
        from .loop.tenant import TenantOptions

        for key, default in TenantOptions.DEFAULTS.items():
            setattr(self, key, default)
        self.loop_dir = "loop"
        self.loop_cycle_period_s = 2.0
        self.loop_max_cycles = 0  # stop fine-tuning after N trained cycles
        self.capture_predict = 0  # log /predict rows and predictions too
        # keys inside 'tenant = <name>' .. 'tenant = end' belong to that
        # tenant (task=loop_fleet), not to this task
        self._in_tenant_section = False
        # the data service (task=data_service)
        self.data_service_host = "127.0.0.1"
        self.data_service_port = 0  # 0 picks an ephemeral port
        self.data_service_http_port = 0
        self.data_service_max_sessions = 64
        self.data_service_cache_mb = 256.0
        self.data_service_window = 4
        self.data_service_ready_file = ""
        self.name_pred = "pred.txt"
        self.extract_node_name = ""
        self.output_format = 1  # 1: txt rows (the default), 0: <f4 binary
        self.cfg: List[tuple] = []

    def set_param(self, name: str, val: str) -> None:
        # a tenant section passes through untouched: its model_dir (or
        # any key) must not clobber this task's; loop/tenant.py splits
        # the sections out of the stream again
        if name == "tenant":
            self._in_tenant_section = val != "end"
            self.cfg.append((name, val))
            return
        if self._in_tenant_section:
            self.cfg.append((name, val))
            return
        if val == "default":
            return
        if name == "task":
            self.task = val
        elif name == "num_round":
            self.num_round = int(val)
        elif name == "max_round":
            self.max_round = int(val)
        elif name == "start_counter":
            self.start_counter = int(val)
        elif name == "continue":
            self.continue_training = int(val)
        elif name == "save_model":
            self.save_period = int(val)
        elif name == "print_step":
            self.print_step = int(val)
        elif name == "divergence_policy":
            self.divergence_policy = "" if val == "off" else val
        elif name == "divergence_lr_backoff":
            self.divergence_lr_backoff = float(val)
        elif name == "divergence_max_retries":
            self.divergence_max_retries = int(val)
        elif name == "integrity_probe":
            self.integrity_probe = int(val)
        elif name == "integrity_every":
            self.integrity_every = int(val)
        elif name == "integrity_shadow":
            self.integrity_shadow = int(val)
        elif name == "test_io":
            self.test_io = int(val)
        elif name == "telemetry":
            self.telemetry = int(val)
        elif name == "telemetry_path":
            self.telemetry_path = val
        elif name in _TRAIN_LATER and val not in ("", "0"):
            raise NotImplementedError(
                f"{name}={val}: this plane of task=train is not ported yet "
                "(ROADMAP.md queue A item 6, (k): multi-device)")
        elif name == "model_in":
            self.name_model_in = val
        elif name == "model_dir":
            self.name_model_dir = val
        elif name == "silent":
            self.silent = int(val)
        elif name == "serve_host":
            self.serve_host = val
        elif name == "serve_port":
            self.serve_port = int(val)
        elif name == "max_batch_size":
            self.serve_max_batch = int(val)
        elif name == "batch_timeout_ms":
            self.batch_timeout_ms = float(val)
        elif name == "queue_limit":
            self.queue_limit = int(val)
        elif name == "serve_deadline_ms":
            self.serve_deadline_ms = float(val)
        elif name == "drain_timeout_s":
            self.drain_timeout_s = float(val)
        elif name == "watchdog_timeout_s":
            self.watchdog_timeout_s = float(val)
        elif name == "replicas":
            self.replicas = int(val)
        elif name in self._LOOP_KEYS:
            setattr(self, name, type(getattr(self, name))(val))
        elif name == "serve_reload_period":
            self.serve_reload_period = float(val)
        elif name == "reload_breaker_threshold":
            self.reload_breaker_threshold = int(val)
        elif name == "reload_breaker_cooldown_s":
            self.reload_breaker_cooldown_s = float(val)
        elif name == "controller":
            self.controller = int(val)
        elif name == "gen_prompt":
            self.gen_prompt = val
        elif name == "gen_prompt_file":
            self.gen_prompt_file = val  # read lazily in task_generate
        elif name == "gen_len":
            self.gen_len = int(val)
        elif name == "gen_temp":
            self.gen_temp = float(val)
        elif name == "gen_topk":
            self.gen_topk = int(val)
        elif name == "gen_topp":
            self.gen_topp = float(val)
        elif name == "gen_cache":
            self.gen_cache = int(val)
        elif name == "quant":
            self.quant = "" if val in ("0", "off", "none") else val
        elif name == "quant_min_agreement":
            self.quant_min_agreement = float(val)
        elif name == "quant_calib_batches":
            self.quant_calib_batches = int(val)
        elif name == "quant_out":
            self.quant_out = val
        elif name == "quant_report":
            self.quant_report = val
        elif name == "extract_node_name":
            self.extract_node_name = val
        elif name == "output_format":
            self.output_format = 1 if val == "txt" else 0
        elif name == "wire" and val not in ("binary", "json"):
            raise ValueError(f"wire must be binary or json, got {val!r}")
        self.cfg.append((name, val))

    #: closed-loop and data-service keys, parsed to the type of their
    #: default
    _LOOP_KEYS = (
        "loop_dir", "loop_rounds_per_cycle", "loop_replay_ratio",
        "loop_min_records", "loop_max_records", "loop_cycle_period_s",
        "loop_max_cycles", "publish_min_delta", "publish_metric",
        "publish_slice_floor", "publish_slice_min_count",
        "publish_source_field", "capture_predict", "feedback_page_bytes",
        "feedback_rotate_bytes", "feedback_retain_shards",
        "feedback_retain_bytes", "data_service_host", "data_service_port",
        "data_service_http_port", "data_service_max_sessions",
        "data_service_cache_mb", "data_service_window",
        "data_service_ready_file")

    def run(self, argv: List[str]) -> int:
        if len(argv) < 1:
            print("Usage: <config> [name=val ...]")
            return 0
        # the fleet re-launches this invocation per replica (conf and
        # overrides, the fleet keys pinned): serve.fleet.cli_spawn_fn
        self.conf_path = argv[0]
        self.cli_overrides = list(argv[1:])
        for name, val in cfgmod.parse_file(argv[0]):
            self.set_param(name, val)
        for name, val in cfgmod.parse_cli_overrides(argv[1:]):
            self.set_param(name, val)
        if self.task not in _TASKS:
            raise ValueError(f"unknown task {self.task!r}")
        from . import obs
        from .utils import faults

        faults.configure(self.cfg)
        # the observability plane: spans, the event log, the device
        # samples and the alert rules, all off unless their keys are set
        obs.configure(self.cfg)
        if self.task == "serve":
            self.task_serve()
        elif self.task == "serve_train":
            self.task_serve_train()
        elif self.task == "loop_fleet":
            self.task_loop_fleet()
        elif self.task == "data_service":
            self.task_data_service()
        elif self.task in ("train", "finetune"):
            self.task_train()
        elif self.task in ("pred", "pred_raw"):
            self.init_model_task()
            self.task_predict(raw=self.task == "pred_raw")
        elif self.task == "extract":
            self.init_model_task()
            self.task_extract()
        elif self.task == "summary":
            self.init_model_task()
            self.task_summary()
        elif self.task == "generate":
            self.task_generate()
        else:
            return self.task_export_quant()
        return 0

    # ------------------------------------------------------------------
    # train
    def _create_trainer(self):
        from .nnet.trainer import NetTrainer

        tr = NetTrainer()
        tr.set_params(self.cfg)
        return tr

    def _load_trainer(self, path: str):
        """A fresh trainer with ``path`` loaded, transient I/O retried
        under the ``retry_*`` keys (the serving engine's policy)."""
        from .utils.faults import RetryPolicy

        tr = self._create_trainer()
        RetryPolicy.from_cfg(self.cfg).run(
            lambda: tr.load_model(path), what=f"loading {path}",
            silent=bool(self.silent))
        return tr

    def _net_fingerprint(self) -> Optional[str]:
        from .nnet.graph import NetGraph
        from .utils import checkpoint as ckpt

        g = NetGraph()
        g.configure(self.cfg)
        return ckpt.net_fingerprint(g.structure_to_json())

    def init_train(self) -> None:
        """The trainer (fresh, ``model_in``, or resumed) and the
        iterators of the conf's ``data`` and ``eval`` sections."""
        from .utils import checkpoint as ckpt

        if self.task != "train":
            self.continue_training = 0
        if self.continue_training:
            found = ckpt.find_latest_valid(
                self.name_model_dir, net_fp=self._net_fingerprint(),
                silent=bool(self.silent))
            if found is None:
                raise FileNotFoundError(
                    "Init: cannot find models for continue training; "
                    "specify model_in instead")
            round_, path = found
            self.net_trainer = self._create_trainer()
            self.net_trainer.load_model(path)
            self.start_counter = round_ + 1
            from .obs import emit as obs_emit

            obs_emit("checkpoint.restore", round=round_, path=path)
            print(f"Init: Continue training from round {self.start_counter}")
        elif self.name_model_in == "NULL":
            self.net_trainer = self._create_trainer()
            self.net_trainer.init_model()
        elif self.task == "finetune":
            self.net_trainer = self._create_trainer()
            self.net_trainer.copy_model_from(self.name_model_in)
        else:
            stem = os.path.basename(self.name_model_in).split(".")[0]
            if stem.isdigit():
                self.start_counter = int(stem)
            else:
                print("WARNING: cannot infer start_counter from model name; "
                      "set it in the config if needed")
            self.net_trainer = self._create_trainer()
            self.net_trainer.load_model(self.name_model_in)
            self.start_counter += 1
        self._create_iterators()

    def init_model_task(self) -> None:
        """The model of ``model_in`` (``summary`` may go without one: a
        fresh init from the conf) and the task's iterators."""
        if self.name_model_in == "NULL" and self.task != "summary":
            raise ValueError(f"task={self.task} needs model_in")
        self.net_trainer = self._create_trainer()
        if self.name_model_in == "NULL":
            self.net_trainer.init_model()
        else:
            self.net_trainer.load_model(self.name_model_in)
        self._create_iterators()

    def _create_iterators(self) -> None:
        """The iterators of the conf's sections that the task reads:
        ``data`` and ``eval`` but for the predicting tasks, ``pred``
        (whose tag names the output file) for ``pred``, ``pred_raw`` and
        ``extract``."""
        from .io.data import create_iterator

        split = cfgmod.split_sections(self.cfg)
        for sec in split.sections:
            if sec.kind == "data" and self.task not in (
                    "pred", "pred_raw", "generate", "summary",
                    "export_quant"):
                if self.itr_train is not None:
                    raise ValueError("can only have one data section")
                self.itr_train = create_iterator(sec.entries)
            elif sec.kind == "eval" and self.task not in (
                    "pred", "pred_raw", "generate", "summary"):
                self.itr_evals.append(create_iterator(sec.entries))
                self.eval_names.append(sec.tag)
            elif sec.kind == "pred":
                self.name_pred = sec.tag
                if self.task in ("pred", "pred_raw", "extract"):
                    if self.itr_pred is not None:
                        raise ValueError("can only have one pred section")
                    self.itr_pred = create_iterator(sec.entries)
        for it in [self.itr_train, self.itr_pred, *self.itr_evals]:
            if it is not None:
                for n, v in split.global_entries:
                    it.set_param(n, v)
                it.init()

    def _close_iterators(self) -> None:
        for it in [self.itr_train, self.itr_pred, *self.itr_evals]:
            if it is not None:
                it.close()

    def _probe_block(self) -> Optional[dict]:
        """The canary's manifest ``probe`` block (``integrity_probe =
        1``): the probe batch's spec and, for an unquantized model, the
        CRC of its scores, padded to its bucket and scored as the
        serving engine scores it, so the golden binds an engine on the
        same backend."""
        if not self.integrity_probe or self.net_trainer is None:
            return None
        from .integrity import canary
        from .serve.cache import ShapeBucketCache

        tr = self.net_trainer
        rows = max(1, min(int(tr.batch_size) or 8, 8))
        shape = tuple(tr.net.input_node_shape(tr.batch_size))[1:]
        seed = 0xC0FFEE ^ int(tr.seed or 0)
        crc = None
        if not tr.quant_scheme:
            probe = canary.probe_batch(seed, rows, shape)
            crc = canary.scores_crc(ShapeBucketCache(tr).scores(probe))
        return canary.make_probe_block(seed, rows, shape, crc,
                                       canary.backend_of(tr.device))

    def _save_model(self, force: bool = False) -> bool:
        """Write ``<start_counter>.model`` (every ``save_model`` rounds,
        or now when ``force``) and advance the round counter."""
        round_ = self.start_counter
        path = os.path.join(self.name_model_dir, f"{round_:04d}.model")
        self.start_counter += 1
        if self.save_period == 0 or (
                not force and self.start_counter % self.save_period != 0):
            return False
        os.makedirs(self.name_model_dir, exist_ok=True)
        self.net_trainer.save_model(path, round_=round_,
                                    probe=self._probe_block())
        return True

    def task_train(self) -> None:
        from .integrity.plane import IntegrityError
        from .obs import emit as obs_emit
        from .obs import trace as obs_trace
        from .utils.checkpoint import DivergenceError, PreemptionHandler
        from .utils.profiler import StepTimer, TraceController

        self.init_train()
        self._train_start = time.time()
        tracer = TraceController()
        tracer.configure(self.cfg)
        try:
            if self.continue_training == 0 and self.name_model_in == "NULL":
                self._save_model()
            else:
                for it, nm in zip(self.itr_evals, self.eval_names):
                    sys.stderr.write(self.net_trainer.evaluate(it, nm))
                sys.stderr.write("\n")
                sys.stderr.flush()
            if self.itr_train is None:
                return
            if self.test_io:
                print("start I/O test")
            timer = StepTimer()
            obs_emit("train.start", task=self.task, round=self.start_counter,
                     num_round=self.num_round)
            preempt = PreemptionHandler().install()
            self._divergence_retries, self._lr_scale = 0, 1.0
            self._global_step = 0
            # the integrity plane: the state loaded or initialized before
            # the loop is the clean baseline
            if self.integrity_every > 0 and self._integrity is None:
                from .integrity import IntegrityPlane

                self._integrity = IntegrityPlane(self.integrity_every,
                                                 self.integrity_shadow)
                self._integrity.last_clean_round = self.start_counter - 1
            tuner = self._start_train_controller()
            try:
                budget = self.max_round
                while self.start_counter <= self.num_round and budget > 0:
                    budget -= 1
                    try:
                        with obs_trace.span("train.round",
                                            round=self.start_counter):
                            completed = self._train_one_round(
                                preempt, timer, tracer)
                    except DivergenceError as e:
                        if self._handle_divergence(e):
                            budget += 1  # the aborted attempt keeps its budget
                            continue
                        raise
                    self._divergence_retries = 0  # a round completed
                    if (completed and self._integrity is not None
                            and self._integrity.due(self.start_counter - 1)):
                        # the vote (and the shadow audit) at the round
                        # boundary, BEFORE the checkpoint: a state that
                        # failed is never saved
                        try:
                            self._integrity.check_round(
                                self.net_trainer, self.start_counter - 1)
                        except IntegrityError as e:
                            if not self._handle_integrity(e):
                                raise
                    if not completed or preempt.requested:
                        last = self.start_counter - 1
                        snapshotted = self._save_model(force=True)
                        obs_emit("train.preempted", round=last,
                                 snapshotted=snapshotted)
                        if snapshotted:
                            print(f"preemption: state saved through round "
                                  f"{last} ({last:04d}.model); resume with "
                                  "continue=1", flush=True)
                        else:
                            print("preemption: exiting (checkpointing "
                                  "disabled, save_model=0)", flush=True)
                        return
                    self._save_model()
            finally:
                if tuner is not None:
                    tuner.stop()
                preempt.uninstall()
                obs_trace.tracer().flush_window(self._global_step)
            obs_emit("train.end", rounds=self.start_counter - 1,
                     elapsed_s=time.time() - self._train_start)
            if not self.silent:
                print(f"\nupdating end, "
                      f"{int(time.time() - self._train_start)} sec in all")
        finally:
            tracer.close()
            self._close_iterators()

    def _handle_integrity(self, e) -> bool:
        """The response to an integrity verdict.  On one process (or a
        vote that named no replica) there is no healthy majority to
        rebuild onto: print ``INTEGRITY: ...`` and return False, so the
        error stops the run before the round is saved.  The JAX
        package's elastic quarantine (evict the named rank, rebuild on
        the last verified round) waits for multi-device support."""
        print(f"INTEGRITY: {e}", flush=True)
        from .integrity.plane import _world_size

        if e.rank is None or _world_size() == 1:
            return False
        raise NotImplementedError(
            "integrity quarantine across processes: the elastic rebuild "
            "waits for multi-device support (ROADMAP.md item A6)")

    # ------------------------------------------------------------------
    # the tuner (tune/): controller = 1
    def _start_controller(self, knobs, objective, on_tick=None,
                          name="tune"):
        from .tune import KnobController, options_from_cfg

        opts = options_from_cfg(self.cfg)
        ctrl = KnobController(
            objective, knobs,
            period_s=opts.period_s, band=opts.band,
            measure_ticks=opts.measure_ticks,
            settle_ticks=opts.settle_ticks,
            cooldown_ticks=opts.cooldown_ticks,
            name=name, on_tick=on_tick,
        )
        ctrl.start()
        if not self.silent:
            print(f"controller: tuning {[k.name for k in knobs]} "
                  f"every {opts.period_s:g}s (band {opts.band:g})",
                  flush=True)
        return ctrl

    def _start_train_controller(self):
        """``controller = 1`` under training: tune the decode pool
        (workers and in-flight window) against the rows the round loop
        dispatches.  None without the key or without a decode pool."""
        if not self.controller or self.itr_train is None:
            return None
        from .tune import find_pipeline, options_from_cfg, pipeline_knobs

        opts = options_from_cfg(self.cfg)
        knobs = []
        if opts.wants("pipeline"):
            pipe = find_pipeline(self.itr_train)
            if pipe is not None:
                knobs.extend(pipeline_knobs(pipe))
        if not knobs:
            if not self.silent:
                print("controller=1: no tunable pipeline stage in this "
                      "iterator chain; controller idle", flush=True)
            return None
        bs = float(self.net_trainer.batch_size or 1)
        return self._start_controller(
            knobs,
            objective=lambda: float(getattr(self, "_global_step", 0)) * bs,
            name="train",
        )

    def _start_serve_controller(self, engine):
        """``controller = 1`` under serving: tune the micro-batcher
        (limit and window) against the rows its batches ran, with the
        bucket prewarm every tick."""
        if not self.controller:
            return None
        from .tune import batcher_knobs, options_from_cfg

        opts = options_from_cfg(self.cfg)
        knobs = batcher_knobs(engine) if opts.wants("batcher") else []
        if not knobs:
            return None
        return self._start_controller(
            knobs,
            objective=lambda: float(engine.stats.batch_rows),
            on_tick=engine.prewarm_buckets,
            name="serve",
        )

    def _handle_divergence(self, e) -> bool:
        """The response to a guard trip under ``divergence_policy``.
        ``rollback``: a fresh trainer from the newest valid checkpoint
        whose weights are finite (falling back past poisoned ones), its
        rates times the cumulative back-off, the round counter after
        that checkpoint's round; at most ``divergence_max_retries``
        times in a row.  True to go on training; False aborts (the
        ``abort`` policy, or nothing left to try)."""
        from .obs import emit as obs_emit
        from .utils import checkpoint as ckpt

        obs_emit("divergence.trip", error=str(e),
                 policy=self.divergence_policy or "abort",
                 retries=self._divergence_retries)
        print(f"DIVERGENCE: {e}", flush=True)
        if self.divergence_policy != "rollback":
            return False
        if self._divergence_retries >= self.divergence_max_retries:
            print(f"divergence: giving up after {self._divergence_retries} "
                  "consecutive rollbacks", flush=True)
            return False
        # an injected fault is one-shot: the rebuilt trainer must not
        # arm it again
        self.cfg = [(n, v) for n, v in self.cfg
                    if n not in ("inject_nan_step", "inject_spike_step")]
        bound = None  # exclusive upper round bound while falling back
        while True:
            found = ckpt.find_latest_valid(
                self.name_model_dir, net_fp=self._net_fingerprint(),
                silent=bool(self.silent), before=bound)
            if found is None:
                print("divergence: no valid checkpoint to roll back to",
                      flush=True)
                return False
            round_, path = found
            tr = self._load_trainer(path)
            if tr.weights_finite():
                break
            print(f"divergence: checkpoint {path} carries non-finite "
                  "weights; falling back past it", flush=True)
            bound = round_
        self._divergence_retries += 1
        if self.divergence_lr_backoff != 1.0:
            self._lr_scale *= self.divergence_lr_backoff
            tr.scale_learning_rate(self._lr_scale)
        self.net_trainer = tr
        self.start_counter = round_ + 1
        obs_emit("divergence.rollback", round=round_, path=path,
                 lr_scale=self._lr_scale, retry=self._divergence_retries)
        print(f"divergence: rolled back to round {round_} ({path}), "
              f"lr scale now {self._lr_scale:g} "
              f"(retry {self._divergence_retries}/"
              f"{self.divergence_max_retries})", flush=True)
        return True

    def _train_one_round(self, preempt, timer, tracer) -> bool:
        """One pass over the data section; False when a preemption
        request stopped it after a batch.  Each step's lap runs from the
        previous fence to the end of this step's wait for the card (the
        batch's fetch, the step, the wait), so the laps tile the round's
        wall time and the rate is the pipeline's."""
        from .io.augment import ANCHOR_KEY
        from .obs import trace as obs_trace
        from .utils.profiler import pipeline_stats

        tr = self.net_trainer
        round_ = self.start_counter - 1
        if not self.silent:
            print(f"update round {round_}", flush=True)
        tr.start_round(self.start_counter)
        # the round's augmentation epoch is its counter, set before the
        # rewind so that threadbuffer's producer takes it with the rewind
        self.itr_train.set_param(ANCHOR_KEY, str(self.start_counter))
        self.itr_train.before_first()
        timer.clear()
        pipeline_stats().reset()  # the round's stage breakdown
        pipe_mark = time.perf_counter()  # the last fence: a lap's start
        batches = 0
        while self.itr_train.next():
            batches += 1
            if self.test_io == 0:
                tracer.step(self._global_step)
                obs_trace.step(self._global_step)
                with obs_trace.span("train.dispatch", steps=1):
                    tr.update(self.itr_train.value())
                t0 = time.perf_counter()
                with obs_trace.span("train.device_wait", steps=1):
                    tr.sync()
                now = time.perf_counter()
                pipeline_stats().add("device_wait", now - t0,
                                     rows=tr.batch_size)
                timer.add(now - pipe_mark)
                pipe_mark = now
                self._global_step += 1
            if (self.print_step > 0 and batches % self.print_step == 0
                    and not self.silent):
                print(f"round {round_:8d}:[{batches:8d}] "
                      f"{int(time.time() - self._train_start)} sec elapsed",
                      flush=True)
            if preempt.requested:
                return False
        stage_line = pipeline_stats().report()
        if not self.silent and stage_line:
            print(f"round {round_:8d} pipeline: " + stage_line, flush=True)
        if self.test_io:
            return True
        if not self.silent and timer.count:
            print(f"round {round_:8d}: " + timer.report(tr.batch_size),
                  flush=True)
        sys.stderr.write(f"[{self.start_counter}]")
        text = ""
        if not self.itr_evals:
            text += tr.evaluate(None, "train")
        for it, nm in zip(self.itr_evals, self.eval_names):
            text += tr.evaluate(it, nm)
        sys.stderr.write(text + "\n")
        sys.stderr.flush()
        self._write_telemetry(timer, text, batches)
        return True

    def _write_telemetry(self, timer, eval_text: str,
                         n_batches: int) -> None:
        """Append one JSON record a round to ``telemetry_path``
        (``telemetry = 1``) through ``diskio.append_bytes`` at the
        ``obs.append`` site: what the round's lines print (the eval
        metrics, the step timing, the learning rate, the stage timers),
        the card's counters (``obs.device.summary()``) and the integrity
        plane's block.  Never raises: a failed write is counted
        (``events_dropped_total{sink="telemetry"}``), logged once, and
        training goes on."""
        if not self.telemetry:
            return
        import errno
        import json
        import re

        from .obs import device as obs_device
        from .obs import events as obs_events
        from .utils import diskio
        from .utils.profiler import pipeline_stats

        metrics = {
            m.group(1): float(m.group(2))
            for m in re.finditer(
                r"(\S+?):([-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?)",
                eval_text or "")
        }
        lr = None
        try:
            up = next(iter(self.net_trainer.updaters.values()))
            lr = float(up.param.base_lr)
        except (StopIteration, AttributeError):
            pass
        record = {
            "ts": time.time(),
            "round": self.start_counter - 1,
            "steps": timer.count,
            "batches": n_batches,
            "elapsed_s": time.time() - self._train_start,
            "lr": lr,
            "eval": metrics,
            "step": timer.summary(self.net_trainer.batch_size),
            "stages": pipeline_stats().snapshot(),
            "device": obs_device.summary(),
        }
        if self._integrity is not None:
            record["integrity"] = self._integrity.snapshot()
        try:
            line = json.dumps(record, separators=(",", ":")) + "\n"
            diskio.append_bytes(self.telemetry_path, line.encode("utf-8"),
                                site="obs.append")
        except (OSError, ValueError, TypeError) as e:
            reason = ("disk" if getattr(e, "errno", None) == errno.ENOSPC
                      else "io")
            obs_events.record_drop("telemetry", reason)
            obs_events.log_exception_once(
                "cli.telemetry", e, kind="telemetry.error",
                path=self.telemetry_path)

    def task_predict(self, raw: bool = False) -> None:
        """``task=pred``: one prediction a line.  ``task=pred_raw``: each
        output row space-separated, with the reference's trailing
        separator.  Written batch by batch, so memory stays one batch."""
        import numpy as np

        if self.itr_pred is None:
            raise ValueError(
                "must specify a pred iterator to generate predictions")
        print("start predicting...")
        t0 = time.perf_counter()
        nrow = 0
        try:
            with open(self.name_pred, "w", encoding="utf-8") as fo:
                self.itr_pred.before_first()
                while self.itr_pred.next():
                    batch = self.itr_pred.value()
                    n = batch.batch_size - batch.num_batch_padd
                    if raw:
                        rows = self.net_trainer.extract_feature(batch,
                                                                "top[-1]")
                        for r in rows.reshape(rows.shape[0], -1)[:n]:
                            fo.write(" ".join(f"{v:g}" for v in r) + " \n")
                    else:
                        for v in self.net_trainer.predict(
                                batch.data, batch.extra_data)[:n]:
                            if np.ndim(v):  # sequence models: (T,) ids
                                fo.write(" ".join(f"{t:g}" for t in v) + "\n")
                            else:
                                fo.write(f"{v:g}\n")
                    fo.flush()
                    nrow += n
        finally:
            self._close_iterators()
        dt = time.perf_counter() - t0
        print(f"finished prediction, write into {self.name_pred} "
              f"({nrow} rows, {nrow / dt if dt > 0 else 0.0:.1f} rows/sec)")

    def task_extract(self) -> None:
        """``task=extract``: the features of node ``extract_node_name``
        for every row of the pred iterator, as ``<f4`` binary or txt
        rows, and the ``.meta`` line ``n,d0,d1,d2``."""
        if self.itr_pred is None:
            raise ValueError(
                "must specify a pred iterator for feature extraction")
        if not self.extract_node_name:
            raise ValueError(
                "extract_node_name must be specified in task extract")
        print("start predicting...")
        nrow, dshape = 0, None
        try:
            with open(self.name_pred,
                      "w" if self.output_format else "wb") as fo:
                self.itr_pred.before_first()
                while self.itr_pred.next():
                    batch = self.itr_pred.value()
                    n = batch.batch_size - batch.num_batch_padd
                    feats = self.net_trainer.extract_feature(
                        batch, self.extract_node_name)[:n]
                    nrow += n
                    flat = feats.reshape(feats.shape[0], -1)
                    if self.output_format:
                        for row in flat:
                            fo.write(" ".join(f"{v:g}" for v in row) + " \n")
                    else:
                        flat.astype("<f4").tofile(fo)
                    if n:
                        dshape = feats.shape[1:]
        finally:
            self._close_iterators()
        shp = list(dshape) if dshape else []
        shp += [1] * (3 - len(shp))
        with open(self.name_pred + ".meta", "w", encoding="utf-8") as fm:
            fm.write(f"{nrow},{shp[0]},{shp[1]},{shp[2]}\n")
        print(f"finished prediction, write into {self.name_pred}")

    def task_summary(self) -> None:
        """``task=summary``: the layer table (type, name, output node
        shape, parameter count) and the total, the JAX package's table
        without its mesh line (one device here)."""
        tr = self.net_trainer
        g = tr.graph
        shapes = tr.net.node_shapes
        total = 0
        print(f"{'#':>3} {'layer':22s} {'type':18s} {'out shape':20s} "
              f"{'params':>12}")
        for i, spec in enumerate(g.layers):
            key = tr.net.param_key[i]
            n_par = 0
            if spec.type_name != "shared" and key in tr.params:
                n_par = int(sum(w.numel() for w in tr.params[key].values()))
                total += n_par
            out = shapes[spec.nindex_out[0]] if spec.nindex_out else ()
            print(f"{i:>3} {spec.name or '':22s} {spec.type_name:18s} "
                  f"{str(tuple(out)):20s} {n_par:>12,}")
        print(f"{'':66s}{'-' * 12}")
        print(f"total parameters: {total:,} ({total * 4 / 1e6:.1f} MB f32)")

    def task_generate(self) -> None:
        """Load ``model_in`` and write the generated text to the ``pred``
        section's file (``pred.txt`` without one) and to stdout."""
        from .nnet.generate import generate

        if self.name_model_in == "NULL":
            raise ValueError("task=generate needs model_in (a trained "
                             "language model's checkpoint)")
        tr = self._create_trainer()
        tr.load_model(self.name_model_in)
        self.net_trainer = tr
        prompt = self.gen_prompt
        if self.gen_prompt_file:
            with open(self.gen_prompt_file, "rb") as f:
                prompt = f.read().decode("utf-8", "replace")
        text = generate(tr, prompt, self.gen_len, self.gen_temp,
                        cache=bool(self.gen_cache), topk=self.gen_topk,
                        topp=self.gen_topp, silent=bool(self.silent))
        preds = cfgmod.split_sections(self.cfg).find("pred")
        name_pred = preds[-1].tag if preds else "pred.txt"
        with open(name_pred, "w", encoding="utf-8") as fo:
            fo.write(text)
        if not self.silent:
            print(f"generated {len(text.encode())} bytes -> {name_pred}")
            print(text)

    def task_export_quant(self) -> int:
        """The gated quantized export of ``model_in``: prints the JSON
        verdict; 0 on publish, 3 on reject."""
        import json

        from .nnet import quant as nquant
        from .utils.checkpoint import atomic_write_bytes

        if self.name_model_in == "NULL":
            raise ValueError("task=export_quant needs model_in (the trained "
                             "f32 checkpoint to quantize)")
        self._create_iterators()
        try:
            verdict = nquant.export_quantized(
                self.cfg, self.name_model_in,
                eval_iter=self.itr_evals[0] if self.itr_evals else None,
                scheme=self.quant or "int8",
                min_agreement=self.quant_min_agreement,
                calib_batches=self.quant_calib_batches,
                out_path=self.quant_out or None, silent=bool(self.silent))
        finally:
            self._close_iterators()
        line = json.dumps(verdict, separators=(",", ":"))
        print(line, flush=True)
        if self.quant_report:
            atomic_write_bytes(self.quant_report, (line + "\n").encode())
        return 0 if verdict["ok"] else 3

    def task_serve_fleet(self) -> None:
        """``task=serve`` with ``replicas >= 2``: the serving fleet (the
        module docstring).  A signal while replicas boot aborts the boot
        (the ``SystemExit`` lands in ``fleet.start()`` on this thread and
        the ``finally`` reaps the children); once bound, it drains."""
        import signal as _signal
        import threading

        from .serve.fleet import FleetOptions, ServingFleet, cli_spawn_fn

        opts = FleetOptions.from_cfg(self.cfg)
        model_dir = (self.name_model_dir
                     if self.name_model_in == "NULL" else None)
        log_dir = opts.log_dir or (
            os.path.join(model_dir, "fleet_logs") if model_dir
            else "fleet_logs")
        spawn = cli_spawn_fn(self.conf_path, self.cli_overrides,
                             host=self.serve_host, opts=opts,
                             log_dir=log_dir)
        fleet = ServingFleet(
            opts, spawn_fn=spawn, host=self.serve_host,
            port=self.serve_port, model_dir=model_dir,
            default_deadline_ms=self.serve_deadline_ms,
            reload_period_s=self.serve_reload_period,
            silent=bool(self.silent),
        )
        httpd_box = {}

        def _stop(signum, frame):
            print(f"fleet: shutdown requested, draining (up to "
                  f"{self.drain_timeout_s:g}s)", flush=True)
            h = httpd_box.get("httpd")
            if h is not None:
                threading.Thread(target=h.shutdown, daemon=True).start()
            else:
                raise SystemExit(0)

        prev = {s: _signal.signal(s, _stop)
                for s in (_signal.SIGTERM, _signal.SIGINT)}
        try:
            httpd = fleet.start()
            httpd_box["httpd"] = httpd
            h = fleet.healthz()
            print(f"fleet: serving {h['rotation']}/{opts.replicas} "
                  f"replica(s) (round {h['round']}) on "
                  f"http://{self.serve_host}:{httpd.server_port}",
                  flush=True)
            httpd.serve_forever(poll_interval=0.2)
        finally:
            for s, p in prev.items():
                _signal.signal(s, p)
            fleet.close(self.drain_timeout_s)
        print("fleet: shutdown complete", flush=True)

    def task_serve(self) -> None:
        """Run the online inference server until SIGTERM/SIGINT;
        ``replicas >= 2`` runs :meth:`task_serve_fleet` instead."""
        if self.replicas > 1:
            return self.task_serve_fleet()
        model_in = (None if self.name_model_in == "NULL"
                    else self.name_model_in)
        engine = self._engine(self.cfg,
                              None if model_in else self.name_model_dir,
                              model_in=model_in)

        def _ready(httpd):
            h = engine.healthz()
            print(f"serving model round {h['round']} (fp {h['net_fp']}) on "
                  f"{h['device']} at "
                  f"http://{httpd.server_address[0]}:{httpd.server_port}",
                  flush=True)

        tuner = self._start_serve_controller(engine)
        try:
            self._serve_until_signal(engine, "serve", _ready, lambda: None)
        finally:
            if tuner is not None:
                tuner.stop()
            engine.close()
        print("serve: shutdown complete", flush=True)

    # ------------------------------------------------------------------
    # the closed loop and the data service
    def _engine(self, cfg, model_dir: Optional[str],
                model_in: Optional[str] = None):
        """A serving engine over ``model_in``, or the newest valid round
        of ``model_dir``, under this task's serving keys."""
        from .serve import Engine

        return Engine(
            cfg=cfg,
            model_in=model_in,
            model_dir=model_dir,
            max_batch_size=self.serve_max_batch,
            batch_timeout_ms=self.batch_timeout_ms,
            queue_limit=self.queue_limit,
            default_deadline_ms=self.serve_deadline_ms,
            silent=bool(self.silent),
            reload_breaker_threshold=self.reload_breaker_threshold,
            reload_breaker_cooldown_s=self.reload_breaker_cooldown_s,
            watchdog_timeout_s=self.watchdog_timeout_s,
        )

    def _refuse_quantized(self, task: str, why: str) -> None:
        if any(n == "quant" and v not in ("", "0", "off", "none")
               for n, v in self.cfg):
            raise ValueError(f"task={task} {why}")

    def _serve_until_signal(self, engine, tag: str, on_ready, on_stop,
                            **serve_kw) -> None:
        """``serve_forever`` until SIGTERM/SIGINT: ``on_ready(httpd)``
        once bound, ``on_stop()`` from the signal (it must not join
        anything), then the drain."""
        from .serve.server import serve_forever

        httpd_box = {}

        def _ready(httpd):
            httpd_box["httpd"] = httpd
            on_ready(httpd)

        def _stop(signum, frame):
            print(f"{tag}: shutdown requested, draining (up to "
                  f"{self.drain_timeout_s:g}s)", flush=True)
            on_stop()
            h = httpd_box.get("httpd")
            if h is not None:
                # shutdown() blocks until serve_forever returns: it must
                # not run on the thread inside serve_forever
                threading.Thread(target=h.shutdown, daemon=True).start()

        prev = {s: signal.signal(s, _stop)
                for s in (signal.SIGTERM, signal.SIGINT)}
        try:
            serve_forever(engine, host=self.serve_host, port=self.serve_port,
                          reload_period_s=self.serve_reload_period,
                          drain_timeout_s=self.drain_timeout_s,
                          verbose=not self.silent, ready_fn=_ready,
                          **serve_kw)
        finally:
            for s, p in prev.items():
                signal.signal(s, p)

    def task_serve_train(self) -> None:
        """``task=serve_train``: serve, collect feedback, fine-tune,
        publish behind the eval gate (the module docstring)."""
        from .loop import ContinuousLoop, FeedbackWriter

        if self.replicas > 1:
            raise ValueError(
                "task=serve_train is single-replica (the fine-tune loop "
                "rides beside one engine); run the fleet with task=serve "
                "and a separate serve_train process if both are needed")
        if not cfgmod.split_sections(self.cfg).find("eval"):
            raise ValueError(
                "task=serve_train needs an eval section — the publish "
                "gate scores candidates on held-out data")
        self._refuse_quantized(
            "serve_train",
            "cannot serve a quantized model: the fine-tune loop trains on "
            "the served weights, and quantized trainers are "
            "inference-only — serve the f32 checkpoints and run "
            "task=export_quant offline")
        # the data section feeds the replay rows, the first eval section
        # the publish gate
        self._create_iterators()
        engine = self._engine(self.cfg, self.name_model_dir)
        feedback = FeedbackWriter(os.path.join(self.loop_dir, "feedback"),
                                  page_bytes=self.feedback_page_bytes,
                                  rotate_bytes=self.feedback_rotate_bytes)
        retention = None
        if self.feedback_retain_shards >= 0:
            from .loop.retention import RetentionOptions, Sweeper

            retention = Sweeper(
                feedback.dir,
                RetentionOptions(self.feedback_retain_shards,
                                 self.feedback_retain_bytes),
                silent=bool(self.silent))
        loop = ContinuousLoop(
            engine, self.cfg, feedback_dir=feedback.dir,
            base_iter=self.itr_train, eval_iter=self.itr_evals[0],
            eval_name=self.eval_names[0] or "eval",
            rounds_per_cycle=self.loop_rounds_per_cycle,
            replay_ratio=self.loop_replay_ratio,
            min_records=self.loop_min_records,
            max_records_per_cycle=self.loop_max_records,
            cycle_period_s=self.loop_cycle_period_s,
            publish_min_delta=self.publish_min_delta,
            publish_metric=self.publish_metric,
            publish_slice_floor=(self.publish_slice_floor
                                 if self.publish_slice_floor >= 0 else None),
            publish_slice_min_count=self.publish_slice_min_count,
            publish_source_field=(self.publish_source_field
                                  if self.publish_source_field >= 0
                                  else None),
            feedback_writer=feedback, retention=retention,
            silent=bool(self.silent))
        loop_thread = threading.Thread(
            target=loop.run, kwargs={"max_cycles": self.loop_max_cycles},
            name="cxxnet-serve-train-loop", daemon=True)

        def _ready(httpd):
            h = engine.healthz()
            print(f"serve_train: serving model round {h['round']} "
                  f"(fp {h['net_fp']}) on {h['device']} at "
                  f"http://{httpd.server_address[0]}:{httpd.server_port}; "
                  f"feedback log at {feedback.dir}", flush=True)
            loop_thread.start()

        tuner = self._start_serve_controller(engine)
        try:
            self._serve_until_signal(
                engine, "serve_train", _ready, loop.stop,
                feedback=feedback,
                capture_predict=bool(self.capture_predict))
        finally:
            if tuner is not None:
                tuner.stop()
            loop.stop()
            if loop_thread.is_alive():
                loop_thread.join(timeout=max(self.drain_timeout_s, 5.0))
            engine.close()
            feedback.close()
            self._close_iterators()
        print("serve_train: shutdown complete", flush=True)

    def task_loop_fleet(self) -> None:
        """``task=loop_fleet``: one engine, feedback log and loop per
        tenant section behind one routed server (the module
        docstring)."""
        from .io.data import create_iterator
        from .loop.tenant import TenantManager
        from .tune import options_from_cfg

        if self.replicas > 1:
            raise ValueError(
                "task=loop_fleet is single-replica per tenant engine; "
                "front a replica fleet with task=serve separately")
        self._refuse_quantized(
            "loop_fleet", "cannot serve quantized models: the fine-tune "
            "loops train on the served weights")
        shared_cfg, tenant_secs = cfgmod.split_tenant_sections(self.cfg)
        if not tenant_secs:
            raise ValueError(
                "task=loop_fleet needs at least one tenant section "
                "(tenant = <name> .. tenant = end)")
        if not cfgmod.split_sections(shared_cfg).find("eval"):
            raise ValueError(
                "task=loop_fleet needs an eval section — every "
                "tenant's publish gate scores on held-out data")

        def make_iters(tenant_cfg):
            # a tenant's own iterators over the shared data and eval
            # sections, its overrides (e.g. seed_data) applied last
            tsplit = cfgmod.split_sections(tenant_cfg)
            data = tsplit.find("data")
            evals = tsplit.find("eval")
            base = create_iterator(data[0].entries) if data else None
            ev = create_iterator(evals[0].entries)
            for it in (base, ev):
                if it is None:
                    continue
                for n, v in tsplit.global_entries:
                    it.set_param(n, v)
                it.init()
            return base, ev, evals[0].tag or "eval"

        manager = TenantManager(
            shared_cfg, tenant_secs, engine_factory=self._engine,
            make_iters=make_iters, loop_dir=self.loop_dir,
            period_s=self.loop_cycle_period_s,
            # the arbiter reads the shared stream: a tune_* key inside a
            # tenant section never retunes the shared controller
            tune_opts=options_from_cfg(shared_cfg),
            silent=bool(self.silent))

        def _ready(httpd):
            names = ", ".join(t.name for t in manager.tenants)
            print(f"loop_fleet: serving {len(manager.tenants)} tenant(s) "
                  f"[{names}] on "
                  f"http://{httpd.server_address[0]}:{httpd.server_port}",
                  flush=True)
            manager.start()

        try:
            # the signal only asks the scheduler to stop: joining it
            # there would stall the accept loop for up to a whole cycle
            self._serve_until_signal(
                manager.tenants[0].engine, "loop_fleet", _ready,
                manager.request_stop,
                capture_predict=bool(self.capture_predict),
                router=manager.router())
        finally:
            manager.close()
        print("loop_fleet: shutdown complete", flush=True)

    def task_data_service(self) -> None:
        """``task=data_service``: the conf's ``data`` section behind the
        ``CXD1`` protocol until SIGTERM/SIGINT (the module docstring)."""
        from .io.dataservice.server import DataServiceServer

        split = cfgmod.split_sections(self.cfg)
        data_secs = split.find("data")
        if not data_secs:
            raise ValueError(
                "task=data_service needs a 'data = train ... iter = "
                "end' section (the chain this server deals)")
        if len(data_secs) > 1:
            raise ValueError("task=data_service serves exactly one "
                             "data section")
        server = DataServiceServer(
            data_secs[0].entries, split.global_entries,
            host=self.data_service_host, port=self.data_service_port,
            http_port=self.data_service_http_port,
            max_sessions=self.data_service_max_sessions,
            cache_bytes=int(self.data_service_cache_mb * (1 << 20)),
            window=self.data_service_window,
            ready_file=self.data_service_ready_file,
            silent=bool(self.silent))

        def _stop(signum, frame):
            print("data_service: shutdown requested", flush=True)
            # shutdown() joins the serve loops: never on their thread
            threading.Thread(target=server.shutdown, daemon=True).start()

        prev = {s: signal.signal(s, _stop)
                for s in (signal.SIGTERM, signal.SIGINT)}
        try:
            server.serve_forever()
        finally:
            for s, p in prev.items():
                signal.signal(s, p)
            server.close()
        print("data_service: shutdown complete", flush=True)


def main(argv: Optional[List[str]] = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    return LearnTask().run(argv)
