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
``%04d.model`` every ``save_model`` rounds (``keep_latest = N`` then
keeps the newest N and their manifests).  SIGTERM/SIGINT finish the
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
``integrity``, with the async step ``async`` and in an elastic group
``elastic``; a failed write is counted and logged once, and training
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
stop a run.  Across the ranks of a data-parallel job the digests are
all-gathered and voted (``integrity/plane.py``): a flipped bit on one
of three ranks is named, on one of two it is found but not named, and
either stops the run; with ``elastic = 1`` the named rank quarantines
itself (exit 41) and the others evict it and rebuild on the last
verified round (see below).
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

Data parallelism (``parallel/``): ``dist_num_proc``, ``dist_proc_id``
and ``dist_coordinator`` (or ``CXN_NUM_PROC``, ``CXN_PROC_ID``,
``CXN_COORDINATOR``) join a ``torch.distributed`` group before anything
touches the card.  ``task=train``/``finetune`` with a device range
(``dev = cpu:0-1``, ``dev = gpu:0-3``) and no ``dist_*`` keys starts
one rank process per listed device (the conf and the overrides, then
``dev = X:i`` and the ``dist_*`` keys of a free loopback coordinator),
waits for them within ``dist_launch_timeout_s`` (default a week), ends
them all when one fails, and exits with the first failing code.  In a
group the conf's ``batch_size`` is global: each rank's ``data`` and
``eval`` chains read ``batch_size / N`` rows of their own worker shard
(``dist_num_worker``, ``dist_worker_rank``; a train chain that cannot
shard is refused), the resume round is the newest every rank holds,
rank 0 writes the checkpoints, the train and eval metrics are summed
over the ranks, and the ``mesh:`` line states the layout, the backend
and the state's bytes per rank.  ``test_on_server = 1`` checks after
every round that the ranks' weights agree (``check_weight_sync``,
``weight-sync:`` on stderr).  ``task=pred``, ``pred_raw`` and
``extract`` over a range read the whole pred set on every rank; each
rank runs its block of every batch (a batch padded to a multiple of the
ranks, ``NetTrainer.run_sharded``) and rank 0 writes the rows in order.
``task=serve`` over a range serves from rank 0 and splits each batch's
forward over the ranks (``serve/range.py``).  The other tasks (and the
serving fleet, ``replicas > 1``) run on one process and refuse a range,
naming themselves.

The elastic pod (``parallel/elastic.py``), as the JAX package drives it:
with ``elastic = 1`` in a ``dist_*`` group rank 0 hosts the membership
coordinator (``elastic_coordinator``, default the ``dist_coordinator``
port + 1), every rank heartbeats it every ``elastic_heartbeat_s``, and
the round, the integrity vote, the preemption sync and the checkpoint
run under the collective deadline (``collective_timeout_s``).  A rank
silent past ``elastic_timeout_s`` (a SIGKILLed peer's gloo error comes
first; the monitor confirms it) makes a new generation: the survivors
tear the group down without a collective, join the next one at the
plan's fresh store address, reload the newest round every survivor
holds, re-shard their iterators and go on (``elastic: rebuilt in ...;
resuming at round R on N process(es)``), at most 5 times in a row
without a completed round, never below ``elastic_min_replicas``.
``elastic_drop_at = R`` plans a shrink at round R's boundary (the
highest rank prints ``elastic: this rank left the mesh at round R
(planned shrink); exiting clean``); a process with ``elastic_join = 1``
and ``elastic_coordinator`` waits (``elastic_rejoin_s``) to be admitted
at a boundary (``elastic_join_at`` pins it), joins the grown group and
loads the consensus round.  The transitions land at the round boundary
after the checkpoint.  A device range does not arm the pod (one line
says so), as the JAX package's one-process range does not.
"""

from __future__ import annotations

import math
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
# the tasks a data-parallel group runs (the others are one process)
_GROUP_TASKS = ("train", "finetune", "pred", "pred_raw", "extract", "serve")


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
        self.keep_latest = 0  # retention: 0 keeps every checkpoint
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
        self.test_on_server = 0  # 1: the ranks' weights compared a round
        self.dist_launch_timeout_s = 7 * 86400.0  # the range launcher's
        # the elastic pod: parsed once in run() (or task_train) from the
        # elastic_* and collective_timeout_s keys
        self.elastic_opts = None
        self.elastic_member = None
        self._elastic_joined = False
        self._elastic_left = False
        self._elastic_drop_done = False
        self._elastic_rebuilds = 0
        self._elastic_consec_recoveries = 0
        self._elastic_attempted_gen = 0
        self._elastic_last_rebuild_s = 0.0
        self._elastic_dev = None  # the rank's dev, kept by every rebuild
        self._integrity_rollback_before = None  # the quarantine's bound
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
        elif name == "keep_latest":
            self.keep_latest = int(val)
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
        elif name == "test_on_server":
            self.test_on_server = int(val)
        elif name == "dist_launch_timeout_s":
            self.dist_launch_timeout_s = float(val)
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
        from .parallel.elastic import ElasticOptions

        self.elastic_opts = ElasticOptions.from_cfg(self.cfg)
        # a joiner has no group yet: it is admitted, joins, loads and
        # builds its iterators inside task_train (_elastic_join_setup)
        if self.elastic_opts.join and self.task != "train":
            raise ValueError("elastic_join=1 only supports task=train")
        launched = self._launch_device_range()
        if launched is not None:
            return launched
        # join the data-parallel group (if any) before anything touches
        # the card: it binds this rank's device
        from .parallel import distributed

        joined = distributed.maybe_init_distributed(self.cfg)
        if joined:
            self._check_group_task()
        code = self._run_task()
        # an elastic run left its group already, without a collective
        if joined and distributed.distributed_initialized():
            # every rank is done: leave the group together (its threads
            # torn down at interpreter exit can abort the process)
            distributed.barrier("exit")
            distributed.shutdown_distributed()
        return code

    def _task_name(self) -> str:
        if self.task == "serve" and self.replicas > 1:
            return f"task=serve with replicas={self.replicas} (the fleet)"
        return f"task={self.task}"

    def _check_group_task(self) -> None:
        """A data-parallel group runs the tasks of ``_GROUP_TASKS`` (the
        serving fleet is a group of its own); refuse the others."""
        if self.task not in _GROUP_TASKS or (self.task == "serve"
                                             and self.replicas > 1):
            raise ValueError(
                f"{self._task_name()} is single-process; a data-parallel "
                f"group runs {_group_task_list()}")

    def _run_task(self) -> int:
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
    # the device-range launcher
    def _launch_device_range(self) -> Optional[int]:
        """A device range (``dev = X:0-3``) with no ``dist_*`` keys: one
        rank process per listed device, each this invocation plus ``dev
        = X:i`` and the ``dist_*`` keys of a free loopback coordinator;
        returns the job's exit code (None when there is no range to
        launch).  The JAX package runs the range as one program over
        the devices; each rank here is one process on one device."""
        from .parallel import distributed
        from .parallel import mesh

        if distributed.distributed_spec(self.cfg) is not None:
            return None
        dev = "tpu"
        for name, val in self.cfg:
            if name == "dev":
                dev = val
        plat, ids = mesh.parse_device(dev.strip().lower())
        if len(ids) < 2:
            return None
        if self.task not in _GROUP_TASKS or (self.task == "serve"
                                             and self.replicas > 1):
            raise NotImplementedError(
                f"dev={dev.strip()}: {self._task_name()} runs on one "
                f"device; a device range runs {_group_task_list()}, one "
                "process per device")
        if plat != "cpu":
            mesh.check_ordinals(dev, ids)
        import socket
        import subprocess

        # the JAX package runs a range as one process, where elastic = 1
        # has nothing to watch; its ranks here end together (wait_ranks)
        pinned = []
        if self.elastic_opts is not None and (self.elastic_opts.elastic
                                              or self.elastic_opts.join):
            pinned = ["elastic=0", "elastic_join=0"]
            print(f"elastic: not armed for the device range dev="
                  f"{dev.strip()} (its rank processes end together, as "
                  "the JAX package's one-process range)", flush=True)

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
        procs = []
        for rank, ordinal in enumerate(ids):
            argv = [sys.executable, "-m", "cxxnet_tpu_torch", self.conf_path,
                    *self.cli_overrides, *pinned, f"dev={plat}:{ordinal}",
                    f"dist_num_proc={len(ids)}", f"dist_proc_id={rank}",
                    f"dist_coordinator=127.0.0.1:{port}"]
            procs.append(subprocess.Popen(argv, env=env))
        if not self.silent:
            print(f"dev={dev.strip()}: {len(ids)} rank processes "
                  f"(pids {[p.pid for p in procs]}), coordinator "
                  f"127.0.0.1:{port}", flush=True)
        return wait_ranks(procs, self.dist_launch_timeout_s)

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
            if not self._sync_latest_model():
                raise FileNotFoundError(
                    "Init: cannot find models for continue training; "
                    "specify model_in instead")
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

    def _locate_agreed_checkpoint(self, before=None):
        """``(round, path)`` of the newest valid checkpoint of
        ``model_dir`` that every rank holds (``agree_on_round``; ``(-1,
        None)`` when any has none), older than round ``before`` when
        given (the quarantine's rollback bound, exclusive).  An agreed
        round older than a rank's newest is validated there, and a rank
        that cannot use it stops every rank (collective)."""
        from .parallel.distributed import agree_on_round, any_process_flag
        from .utils import checkpoint as ckpt

        net_fp = self._net_fingerprint()
        found = ckpt.find_latest_valid(self.name_model_dir, net_fp=net_fp,
                                       silent=bool(self.silent),
                                       before=before)
        local = found[0] if found else -1
        round_ = agree_on_round(local)
        if round_ < 0:
            return -1, None
        path, reason = (found[1], None) if round_ == local else (
            os.path.join(self.name_model_dir, f"{round_:04d}.model"), None)
        if round_ != local:
            if not self.silent:
                print(f"resume: agreed on round {round_} across processes "
                      f"(local newest was {local})")
            reason = ckpt.validate_checkpoint(path, net_fp=net_fp)
        if any_process_flag(reason is not None):
            raise ckpt.CheckpointError(
                f"resume: processes agreed on round {round_} but {path} is "
                f"unusable: {reason or 'unusable on a peer process'}")
        return round_, path

    def _sync_latest_model(self) -> bool:
        """A trainer from the newest valid round every rank holds
        (collective); the round counter after it.  False when a rank
        holds none.  An integrity quarantine sets
        ``_integrity_rollback_before``: the survivors resume from the
        last fingerprint-verified round, not the newest on disk, whose
        state the corrupt rank's gradients may have touched."""
        bound, self._integrity_rollback_before = (
            self._integrity_rollback_before, None)
        round_, path = self._locate_agreed_checkpoint(before=bound)
        if path is None:
            return False
        self.net_trainer = self._load_trainer(path)
        self.start_counter = round_ + 1
        from .obs import emit as obs_emit

        obs_emit("checkpoint.restore", round=round_, path=path)
        return True

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
        from .parallel.distributed import process_info

        # the worker shards are keyed by the data index: the model ranks
        # of one index read the same rows
        plan = (self.net_trainer.mesh_plan if self.net_trainer is not None
                else None)
        pid, nproc = ((plan.data_index, plan.n_data) if plan is not None
                      else process_info())
        for it in [self.itr_train, self.itr_pred, *self.itr_evals]:
            if it is not None:
                for n, v in split.global_entries:
                    it.set_param(n, v)
                if nproc > 1 and (it is self.itr_train
                                  or it in self.itr_evals):
                    self._shard_iterator(it, pid, nproc)
                it.init()

    def _shard_iterator(self, it, pid: int, nproc: int) -> None:
        """A data-parallel group's chain: this data index's worker shard,
        at ``batch_size / nproc`` rows a batch (the conf's ``batch_size``
        is global; ``nproc`` is the number of data indices).  An eval
        chain that cannot shard scores the whole set on every rank (the
        summed metric is the same); a train chain that cannot is
        refused."""
        gbs = self.net_trainer.batch_size
        if gbs % nproc != 0:
            raise ValueError(f"batch_size={gbs} must divide by the "
                             f"process count ({nproc})")
        if not it.supports_dist_shard():
            if it is self.itr_train:
                raise ValueError(
                    "multi-process training needs a train iterator that "
                    "honors dist_num_worker (mnist/imgbin/img/csv/"
                    "synthetic/text); this chain would silently feed every "
                    "process identical data")
            return
        it.set_param("batch_size", str(gbs // nproc))
        it.set_param("dist_num_worker", str(nproc))
        it.set_param("dist_worker_rank", str(pid))

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
        # a group commits the spec only, as the JAX package does: the
        # engine that loads the round records its own golden
        from .parallel.distributed import process_info

        if not tr.quant_scheme and process_info()[1] == 1:
            probe = canary.probe_batch(seed, rows, shape)
            crc = canary.scores_crc(ShapeBucketCache(tr).scores(probe))
        return canary.make_probe_block(seed, rows, shape, crc,
                                       canary.backend_of(tr.device))

    def _save_model(self, force: bool = False) -> bool:
        """Write ``<start_counter>.model`` (every ``save_model`` rounds,
        or now when ``force``) and advance the round counter.  In a
        data-parallel group every rank calls it (collective:
        ``NetTrainer.save_model`` checks the ranks' bytes agree and rank
        0 writes).  After the write, ``keep_latest = N`` prunes all but
        the newest N rounds and their manifests, on rank 0."""
        round_ = self.start_counter
        path = os.path.join(self.name_model_dir, f"{round_:04d}.model")
        self.start_counter += 1
        if self.save_period == 0 or (
                not force and self.start_counter % self.save_period != 0):
            return False
        os.makedirs(self.name_model_dir, exist_ok=True)
        self.net_trainer.save_model(path, round_=round_,
                                    probe=self._probe_block())
        if self.keep_latest > 0:
            from .parallel.distributed import is_primary
            from .utils import checkpoint as ckpt

            if is_primary():
                ckpt.apply_retention(self.name_model_dir, self.keep_latest,
                                     silent=bool(self.silent))
        return True

    def task_train(self) -> None:
        from .integrity.plane import IntegrityError
        from .obs import emit as obs_emit
        from .obs import trace as obs_trace
        from .parallel.distributed import any_process_flag, process_info
        from .utils.checkpoint import DivergenceError, PreemptionHandler
        from .utils.profiler import StepTimer, TraceController

        if self.elastic_opts is None:  # task_train without run()
            from .parallel.elastic import ElasticOptions

            self.elastic_opts = ElasticOptions.from_cfg(self.cfg)
        if self.elastic_opts.join:
            self._elastic_join_setup()
        else:
            self.init_train()
            self._elastic_setup()
        self._print_mesh_summary()
        self._train_start = time.time()
        tracer = TraceController()
        tracer.configure(self.cfg)
        try:
            if self._elastic_joined:
                # the survivors are mid-loop already: an extra
                # collective here (an evaluation, a save) would deadlock
                pass
            elif self.continue_training == 0 and self.name_model_in == "NULL":
                self._elastic_guard(self._save_model,
                                    what="initial checkpoint")
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
            # the loop is the clean baseline; one plane a task, over every
            # rebuild
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
                    if self.elastic_member is not None:
                        self.elastic_member.report_round(self.start_counter)
                    try:
                        with obs_trace.span("train.round",
                                            round=self.start_counter):
                            completed = self._elastic_guard(
                                lambda: self._train_one_round(
                                    preempt, timer, tracer),
                                what=f"train round {self.start_counter}")
                    except DivergenceError as e:
                        if self._handle_divergence(e):
                            budget += 1  # the aborted attempt keeps its budget
                            continue
                        raise
                    except Exception as e:  # noqa: BLE001 - a replica lost?
                        if self._elastic_recover(e):
                            budget += 1  # the aborted round runs again
                            continue
                        raise
                    self._divergence_retries = 0  # a round completed
                    self._elastic_consec_recoveries = 0
                    if (completed and self._integrity is not None
                            and self._integrity.due(self.start_counter - 1)):
                        # the vote (and the shadow audit) at the round
                        # boundary, BEFORE the checkpoint: a state that
                        # failed is never saved
                        try:
                            self._elastic_guard(
                                lambda: self._integrity.check_round(
                                    self.net_trainer,
                                    self.start_counter - 1),
                                what="integrity check")
                        except IntegrityError as e:
                            if self._handle_integrity(e):
                                budget += 1  # the re-run rounds keep theirs
                                continue
                            raise
                        except Exception as e:  # noqa: BLE001
                            if self._elastic_recover(e):
                                continue  # the round completed: re-sync
                            raise
                    try:
                        if process_info()[1] > 1:
                            # one rank's signal stops every rank, at the
                            # round boundary (collective)
                            completed = completed and not self._elastic_guard(
                                lambda: any_process_flag(preempt.requested),
                                what="preemption sync")
                        stop = not completed or preempt.requested
                        snapshotted = self._elastic_guard(
                            lambda: self._save_model(force=stop),
                            what="checkpoint save")
                    except Exception as e:  # noqa: BLE001 - a replica lost?
                        if self._elastic_recover(e):
                            continue  # the round completed: re-sync
                        raise
                    if stop:
                        last = self.start_counter - 1
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
                    # the planned transitions land at the boundary, once
                    # the round's checkpoint is durable; a failed
                    # coordinator call skips this boundary (the drop and
                    # grow latches fire again at the next)
                    if self.elastic_member is not None and (
                            self.start_counter <= self.num_round):
                        try:
                            changed = self._elastic_boundary()
                        except (OSError, ValueError, RuntimeError) as e:
                            obs_emit("mesh.boundary_rpc_failed",
                                     round=self.start_counter, error=str(e))
                            changed = False
                        if changed and self._elastic_left:
                            break  # this rank left (a planned shrink)
            finally:
                if tuner is not None:
                    tuner.stop()
                preempt.uninstall()
                obs_trace.tracer().flush_window(self._global_step)
                if self.elastic_member is not None:
                    self._elastic_quiet_teardown()
            if self._elastic_left:
                obs_emit("mesh.left", round=self.start_counter)
                print(f"elastic: this rank left the mesh at round "
                      f"{self.start_counter} (planned shrink); exiting clean",
                      flush=True)
                return
            obs_emit("train.end", rounds=self.start_counter - 1,
                     elapsed_s=time.time() - self._train_start)
            if not self.silent:
                print(f"\nupdating end, "
                      f"{int(time.time() - self._train_start)} sec in all")
        finally:
            tracer.close()
            self._close_iterators()

    def _handle_integrity(self, e) -> bool:
        """The response to an integrity verdict: print ``INTEGRITY:
        ...``.  Every rank holds the same verdict (the vote ran on the
        all-gathered digests).  With no rank named, on one process, or
        without ``elastic = 1`` there is no healthy majority to rebuild
        onto: False, so the error stops the run before the round is
        saved.  In an elastic group the named rank quarantines itself
        (``integrity.quarantine``, exit 41: it must never add another
        gradient) and the others evict it through the coordinator and
        rebuild on the last fingerprint-verified round; True to go on."""
        from .obs import emit as obs_emit
        from .parallel.distributed import process_info

        rank, num = process_info()
        round_ = self.start_counter - 1
        print(f"INTEGRITY: {e}", flush=True)
        if e.rank is None or num == 1 or self.elastic_member is None:
            return False
        last_clean = self._integrity.last_clean_round
        obs_emit("integrity.quarantine", kind=e.kind, rank=e.rank,
                 tensor=e.tensor, round=round_,
                 last_clean_round=last_clean, self_evict=e.rank == rank)
        if e.rank == rank:
            print(f"integrity: this rank ({rank}) was named corrupt — "
                  "self-quarantining (exit 41)", flush=True)
            self._elastic_quiet_teardown()
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(41)
        # the rebuild rolls back past every unverified round
        # (_sync_latest_model takes the exclusive bound)
        self._integrity_rollback_before = (
            None if last_clean is None else last_clean + 1)
        try:
            plan = self.elastic_member.plan_evict(e.rank, round_)
        except (OSError, ValueError, RuntimeError) as err:
            print(f"integrity: evict RPC failed: {err}", flush=True)
            return False
        if plan.rank is None:
            print("integrity: eviction plan dropped this rank too — "
                  "aborting", flush=True)
            return False
        self._elastic_rebuild("integrity_evict", plan=plan)
        return True

    # ------------------------------------------------------------------
    # the elastic pod (parallel/elastic.py): survive a replica's loss
    # and resize the group within one invocation
    def _elastic_setup(self) -> None:
        """Arm the liveness layer: rank 0 hosts the coordinator, every
        rank heartbeats it.  Nothing unless ``elastic = 1`` in a group
        of more than one rank."""
        opts = self.elastic_opts
        if not opts.elastic:
            return
        from .parallel import elastic as par_elastic
        from .parallel.distributed import distributed_spec, process_info

        spec = distributed_spec(self.cfg)
        if spec is None or process_info()[1] == 1:
            return  # one process: nothing to watch
        coord, num, pid = spec
        addr = opts.resolve_coordinator(coord)
        self.elastic_member = par_elastic.ElasticMember(
            addr, pid, opts, host_coordinator=(pid == 0), num=num,
            jax_host=coord.rsplit(":", 1)[0],
        ).start()
        self._keep_elastic_device()
        if not self.silent:
            print(f"elastic: liveness monitor armed (coordinator "
                  f"{self.elastic_member.addr}, heartbeat "
                  f"{opts.heartbeat_s:g}s, replica timeout "
                  f"{opts.timeout_s:g}s, collective deadline "
                  f"{opts.collective_timeout_s:g}s)", flush=True)

    def _keep_elastic_device(self) -> None:
        """Record the device this rank joined its first generation on:
        every rebuild joins on it again (a rank number that changes
        must not move the process to another card, nor off the card)."""
        from .parallel.distributed import group_device

        d = group_device()
        if d is None:
            raise RuntimeError("elastic: no process group to take the "
                               "rank's device from")
        self._elastic_dev = (f"gpu:{d.index or 0}" if d.type == "cuda"
                             else d.type)

    def _join_generation(self, plan, dev: Optional[str] = None) -> None:
        """Join ``plan``'s group at its fresh store address (the
        rebuild's rendezvous: it blocks until every member arrives),
        the ``dist_*`` entries (and ``dev``) rewritten to match."""
        from .parallel.distributed import DEFAULT_TIMEOUT_S, init_distributed

        updates = {"dist_coordinator": plan.jax_coordinator,
                   "dist_num_proc": str(plan.num),
                   "dist_proc_id": str(plan.rank)}
        if dev is not None:
            updates["dev"] = dev
        self._set_cfg_entries(updates)
        last = dict(self.cfg)
        init_distributed(plan.jax_coordinator, plan.num, plan.rank,
                         dev=last.get("dev", "tpu"),
                         timeout_s=float(last.get("dist_timeout_s",
                                                  DEFAULT_TIMEOUT_S)),
                         resilient=True)

    def _elastic_join_setup(self) -> None:
        """``elastic_join = 1``: this process has no group yet.  Announce
        it to the coordinator, wait for a grow generation to give it a
        rank (``elastic_rejoin_s`` bounds the wait), join that group,
        load the consensus round and shard the iterators; then go
        straight into the round loop beside the survivors."""
        opts = self.elastic_opts
        from .parallel import elastic as par_elastic

        if not opts.coordinator:
            raise ValueError(
                "elastic_join=1 needs elastic_coordinator=host:port "
                "(the running job's membership coordinator)")
        m = par_elastic.ElasticMember(opts.coordinator, -1, opts)
        print(f"elastic: waiting to join the mesh via {opts.coordinator}"
              f" (up to {opts.rejoin_s:g}s"
              + (f", at round {opts.join_at}" if opts.join_at else "")
              + ")", flush=True)
        plan = m.join()
        if plan.rank is None:
            raise RuntimeError("elastic join: admitted without a rank")
        print(f"elastic: admitted as rank {plan.rank}/{plan.num} "
              f"(generation {plan.generation})", flush=True)
        # the heartbeat starts BEFORE the blocking rendezvous: the
        # coordinator registered this member at plan time, and a slow
        # survivor teardown must not get it evicted mid-admission
        m.rank = plan.rank
        m.generation = plan.generation
        m.start()
        self._join_generation(plan)
        self._keep_elastic_device()
        m.ack_generation(plan, rank=plan.rank)
        self.elastic_member = m
        self.continue_training = 1
        if not self._sync_latest_model():
            raise FileNotFoundError(
                "elastic join: no checkpoint in model_dir to sync from")
        self._create_iterators()
        self._elastic_joined = True

    def _elastic_guard(self, fn, what: str):
        """The collective deadline: a dead peer surfaces as
        ``ReplicaLossError`` within ``collective_timeout_s`` instead of
        a hang in a collective.  ``fn`` runs on a worker thread bound to
        this rank's card and the calling thread's stream (a thread's
        current device and stream are its own)."""
        if self.elastic_member is None:
            return fn()
        from .parallel import elastic as par_elastic

        tr = self.net_trainer
        dev = tr.device if tr is not None else None
        if dev is not None and dev.type == "cuda":
            import torch

            stream = torch.cuda.current_stream(dev)
            call = fn

            def fn():
                torch.cuda.set_device(dev)
                with torch.cuda.stream(stream):
                    return call()

        return par_elastic.guarded_call(
            fn, self.elastic_member,
            timeout_s=self.elastic_opts.collective_timeout_s, what=what)

    def _elastic_recover(self, exc: BaseException) -> bool:
        """A round's or a checkpoint's failure: a replica's loss
        rebuilds onto the survivors and returns True (the loop goes
        on); anything else returns False (the error is raised)."""
        if self.elastic_member is None:
            return False
        from .parallel import elastic as par_elastic

        loss = par_elastic.classify_failure(
            exc, self.elastic_member,
            confirm_s=self.elastic_opts.timeout_s + 2.0)
        if loss is None:
            return False
        min_gen = 0
        while True:
            if loss.fatal:
                print(f"elastic: unrecoverable replica loss: {loss}",
                      flush=True)
                return False
            # a lasting error read as a loss would rebuild forever (the
            # caller refunds the round): a completed round resets this
            self._elastic_consec_recoveries += 1
            if self._elastic_consec_recoveries > 5:
                print("elastic: giving up after "
                      f"{self._elastic_consec_recoveries - 1} "
                      "consecutive rebuilds without completing a "
                      "round", flush=True)
                return False
            print(f"elastic: replica loss detected ({loss})", flush=True)
            try:
                self._elastic_rebuild("replica_lost",
                                      min_generation=min_gen)
                return True
            except par_elastic.ReplicaLossError as again:
                # a second replica died in the rebuild's own collectives:
                # wait for the next generation and try again
                loss = again
            except Exception as again:  # noqa: BLE001 - classify
                loss = par_elastic.classify_failure(
                    again, self.elastic_member,
                    confirm_s=self.elastic_opts.timeout_s + 2.0)
                if loss is None:
                    raise
            min_gen = self._elastic_attempted_gen + 1

    def _elastic_boundary(self) -> bool:
        """The planned transitions at a round boundary (its consensus
        checkpoint is durable).  True when the group changed (rebuilt,
        or this rank left)."""
        m = self.elastic_member
        opts = self.elastic_opts
        m.poll_now()  # one beat now: every rank reads the same state
        plan = m.pending_plan()
        if plan is not None and plan.at_round is None:
            # a replica died while this rank sat at the boundary (its
            # own collectives all completed): rebuild now rather than
            # trip over it in the next round
            print(f"elastic: replica loss at round boundary "
                  f"(generation {plan.generation})", flush=True)
            self._elastic_rebuild("replica_lost", plan=plan)
            return True
        r = self.start_counter
        if plan is not None and plan.at_round is not None and (
                plan.at_round <= r):
            # a peer reached this boundary first and minted the planned
            # transition; once minted, a grow's round is gone from the
            # beat, so this rank takes the plan it was handed
            if plan.reason == "planned_shrink":
                self._elastic_drop_done = True
            if plan.rank is None:
                self._elastic_left = True
                return True
            self._elastic_rebuild(plan.reason, plan=plan)
            return True
        if (opts.drop_at and r >= opts.drop_at
                and not self._elastic_drop_done):
            # >= and a latch: a boundary whose call failed tries again
            # at the next round instead of skipping the drop forever
            plan = m.plan_shrink(r)
            self._elastic_drop_done = True
            if plan.rank is None:
                self._elastic_left = True
                return True
            self._elastic_rebuild(plan.reason, plan=plan)
            return True
        g = m.grow_round()
        if g is not None and r >= g:
            plan = m.plan_grow(r)
            if plan is None:
                return False  # every waiter gave up
            self._elastic_rebuild("grow", plan=plan)
            return True
        return False

    def _await_plan(self, min_generation: int = 0):
        """Wait (briefly) for the coordinator's plan for a detected loss
        to arrive over the heartbeat.  ``min_generation`` skips the
        stale plan of a rebuild that itself failed (a second loss)."""
        m = self.elastic_member
        deadline = time.monotonic() + self.elastic_opts.timeout_s * 2 + 5
        while time.monotonic() < deadline:
            p = m.pending_plan()
            if p is not None and p.generation >= min_generation:
                return p
            try:
                m.poll_now()
            except (OSError, ValueError, RuntimeError):
                pass
            time.sleep(0.1)
        return None

    def _set_cfg_entries(self, updates: dict) -> None:
        """Rewrite config entries in place (a generation's ``dist_*``
        identity), so anything that reads the stream again agrees with
        the live group."""
        out, seen = [], set()
        for n, v in self.cfg:
            if n in updates:
                if n in seen:
                    continue  # duplicates collapse to one entry
                out.append((n, updates[n]))
                seen.add(n)
            else:
                out.append((n, v))
        for n, v in updates.items():
            if n not in seen:
                out.append((n, v))
        self.cfg = out

    def _elastic_rebuild(self, reason: str, plan=None,
                         min_generation: int = 0) -> None:
        """The consensus rebuild onto the new process set, inside this
        invocation: tear the group down without a collective, join the
        plan's group, reload the agreed round into a fresh trainer (its
        ``zero`` and model slices cut for the new group) and re-shard
        the iterators; ``start_counter`` goes back to that round + 1.
        With ``dist_shard = block`` and ``det_reduce = 1`` the resumed
        run is the one a planned resize gives, bit for bit."""
        import gc

        from .obs import emit as obs_emit
        from .parallel import elastic as par_elastic
        from .parallel import distributed
        from .utils import checkpoint as ckpt

        m = self.elastic_member
        t0 = time.time()
        par_elastic.set_rebuilding(True)
        try:
            plan = plan or self._await_plan(min_generation)
            if plan is None:
                raise par_elastic.ReplicaLossError(
                    "elastic: replica loss with no generation plan "
                    "(membership coordinator unreachable?)", fatal=True)
            if plan.abort:
                raise par_elastic.ReplicaLossError(
                    f"elastic: cannot continue: {plan.abort}", fatal=True)
            self._elastic_attempted_gen = plan.generation
            obs_emit("mesh.rebuild_start", reason=reason,
                     generation=plan.generation, num=plan.num,
                     rank=plan.rank, round=self.start_counter)
            print(f"elastic: {reason} -> rebuilding the mesh as "
                  f"{plan.num} process(es), this rank becomes "
                  f"{plan.rank} (generation {plan.generation})",
                  flush=True)
            # a guarded worker may still be inside a dead collective: a
            # grace to error out before the group goes; one that stays
            # keeps the group alive under it (abandoned, not destroyed)
            t = par_elastic.guarded_call.last_thread
            abandon = False
            if t is not None and t.is_alive():
                t.join(timeout=min(
                    self.elastic_opts.collective_timeout_s, 10.0))
                if t.is_alive():
                    obs_emit("mesh.guard_thread_abandoned", what=reason)
                    abandon = True
            # drop every reference into the old group before it goes
            self._close_iterators()
            self.itr_train = None
            self.itr_evals = []
            self.eval_names = []
            if self.net_trainer is not None:
                # the async step's aggregates were reduced by the dead
                # generation: stamped out, never applied (the rebuilt
                # trainer loads a drained checkpoint anyway)
                try:
                    self.net_trainer.async_abandon(
                        generation=plan.generation, reason="rebuild")
                except Exception:  # noqa: BLE001 - teardown best-effort
                    pass
            self.net_trainer = None
            gc.collect()
            distributed.shutdown_distributed(graceful=False, abandon=abandon)
            # the device this rank started on, on every attempt (a retry
            # after a second loss has no trainer left to read it from)
            self._join_generation(plan, dev=self._elastic_dev)
            m.ack_generation(plan, rank=plan.rank)
            # the round consensus and the reload on the new process set;
            # the iterators re-shard for the new rank and count
            if not self._sync_latest_model():
                raise ckpt.CheckpointError(
                    "elastic: no valid checkpoint any survivor can "
                    "load — cannot rebuild")
            self._create_iterators()
            dt = time.time() - t0
            self._elastic_rebuilds += 1
            self._elastic_last_rebuild_s = dt
            try:
                from .obs.registry import registry as obs_registry

                obs_registry().counter(
                    "mesh_rebuilds_total",
                    "Elastic mesh rebuilds by trigger.",
                    labelnames=("reason",),
                ).labels(reason=reason).inc()
                obs_registry().gauge(
                    "mesh_rebuild_seconds",
                    "Wall time of the last elastic mesh rebuild.",
                ).set(dt)
            except Exception:  # noqa: BLE001 - telemetry never aborts
                pass
            obs_emit("mesh.rebuild_done", reason=reason,
                     generation=plan.generation, num=plan.num,
                     rank=plan.rank, wall_s=round(dt, 3),
                     resume_round=self.start_counter)
            self._print_mesh_summary()
            print(f"elastic: rebuilt in {dt:.2f}s; resuming at round "
                  f"{self.start_counter} on {plan.num} process(es)",
                  flush=True)
        finally:
            par_elastic.set_rebuilding(False)

    def _elastic_quiet_teardown(self) -> None:
        """The end of an elastic run: leave the coordination plane and
        the group without a collective (``graceful=False``); rank 0
        lingers briefly, so that its coordinator and store outlast every
        peer's last call."""
        from .parallel.distributed import (distributed_initialized,
                                           shutdown_distributed)

        m, self.elastic_member = self.elastic_member, None
        if m is None:
            return
        try:
            m.close()
        except Exception:  # noqa: BLE001 - teardown best-effort
            pass
        if distributed_initialized():
            shutdown_distributed(graceful=False)
        if m.coordinator is not None:  # this process is rank 0
            time.sleep(2.0)

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
        if self.net_trainer is not None:
            # the discarded trainer's pending staleness aggregates are
            # counted and logged as dropped
            self.net_trainer.async_abandon(reason="rollback")
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

        from .parallel.distributed import process_info

        tr = self.net_trainer
        multi = process_info()[1] > 1
        # async data parallelism: the per-step fence moves to the round
        # boundary (async_round_end), or the overlap is gone
        async_on = self.test_io == 0 and tr._async_active()
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
                if not async_on:
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
            if preempt.requested and not multi:
                return False  # a group stops at the round boundary
        if async_on:
            # the round-boundary fence (on resync rounds the staleness
            # buffers drain first), billed as one device_wait lap
            t0 = time.perf_counter()
            tr.async_round_end(self.start_counter)
            dt = time.perf_counter() - t0
            pipeline_stats().add("device_wait", dt,
                                 rows=batches * tr.batch_size)
            timer.add(dt, 0)
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
        if self.test_on_server:
            dev = tr.check_weight_sync()
            sys.stderr.write(f"[{self.start_counter}]\tweight-sync:"
                             f"max_dev={dev:g} ok\n")
            sys.stderr.flush()
        return True

    def _print_mesh_summary(self) -> None:
        """One line of layout at train start in a data-parallel group:
        the mesh, the backend, and this rank's train-state bytes against
        one whole replica (``train_state_shard_bytes`` in
        ``/metricsz``)."""
        tr = self.net_trainer
        plan = tr.mesh_plan if tr is not None else None
        if self.silent or plan is None or plan.n_devices <= 1:
            return
        per_device, total = tr.state_shard_bytes()
        held = max(per_device.values()) if per_device else total
        print(f"mesh: {plan.describe(zero=tr._zero_level())} | train state "
              f"{total / 1e6:.2f} MB replicated -> {held / 1e6:.2f} MB/device "
              f"({held / total if total else 1:.2%} of a full copy)",
              flush=True)

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
        if self.elastic_member is not None or self._elastic_rebuilds:
            from .parallel.distributed import process_info

            record["elastic"] = {
                "rebuilds": self._elastic_rebuilds,
                "last_rebuild_s": round(self._elastic_last_rebuild_s, 3),
                "processes": process_info()[1],
                "generation": (self.elastic_member.generation
                               if self.elastic_member is not None
                               else None),
            }
        async_snap = self.net_trainer.async_snapshot()
        if async_snap is not None:
            # the async pipeline: pending depths, pushes, applies, drops
            # and the round's overlap fraction
            record["async"] = async_snap
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
            with open(self._pred_path(), "w", encoding="utf-8") as fo:
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

    def _pred_path(self, suffix: str = "") -> str:
        """Where a predicting task writes: ``name_pred`` (+ ``suffix``)
        on rank 0; a device range's other ranks compute their block of
        every batch (``NetTrainer.run_sharded``) and write nothing."""
        from .parallel.distributed import is_primary

        return self.name_pred + suffix if is_primary() else os.devnull

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
            with open(self._pred_path(),
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
        with open(self._pred_path(".meta"), "w", encoding="utf-8") as fm:
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
                n_par = sum(math.prod(tr._whole_shape(key, t))
                            for t in tr.params[key])
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
        from .parallel import distributed

        rank, world = distributed.process_info()
        if rank > 0:
            return self._serve_follower(rank)
        leader = None
        if world > 1:
            from .serve import range as serve_range

            leader = serve_range.start_leader(world)
        try:
            self._serve_engine()
        finally:
            if leader is not None:
                serve_range.end_leader()

    def _serve_follower(self, rank: int) -> None:
        """A serving range's rank > 0: compute its block of every batch
        the leader's engine forms, on the checkpoint each names."""
        from .serve import range as serve_range

        serve_range.follow(self._load_trainer, rank, silent=bool(self.silent))

    def _serve_engine(self) -> None:
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


def _group_task_list() -> str:
    return ", ".join(_GROUP_TASKS[:-1]) + f" and {_GROUP_TASKS[-1]}"


def wait_ranks(procs, timeout_s: float) -> int:
    """Wait for the rank processes of a device range: 0 when every rank
    exits 0; else, as soon as one fails (or ``timeout_s`` passes: 124),
    the others are ended (SIGTERM, then SIGKILL after 10 s) and the
    first failing exit code is returned (128 + N for a rank killed by
    signal N).  SIGTERM and SIGINT to this process are passed on to the
    ranks (each snapshots its state as a single-process run does)."""
    def forward(signum, frame):
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    prev = {}
    if threading.current_thread() is threading.main_thread():
        prev = {s: signal.signal(s, forward)
                for s in (signal.SIGTERM, signal.SIGINT)}
    deadline = time.monotonic() + timeout_s
    code = 0
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                code = failed[0] if failed[0] > 0 else 128 - failed[0]
                print(f"rank {codes.index(failed[0])} exited {failed[0]}: "
                      "ending the others", file=sys.stderr, flush=True)
                break
            if all(c == 0 for c in codes):
                return 0
            if time.monotonic() >= deadline:
                code = 124
                print(f"ranks still running after {timeout_s:g} s "
                      "(dist_launch_timeout_s): ending them",
                      file=sys.stderr, flush=True)
                break
            time.sleep(0.05)
    finally:
        for s, h in prev.items():
            signal.signal(s, h)
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except Exception:  # noqa: BLE001 - a rank ignoring SIGTERM
                p.kill()
                p.wait()
    return code


def _hard_exit_if_resilient(rc: int) -> None:
    """An elastic run may hold a group abandoned under a wedged thread,
    which the interpreter's teardown could wait on: flush and end the
    process at once.  Everything it writes (checkpoints, manifests,
    telemetry, events) is flushed at write time."""
    from .parallel.distributed import resilient_client_used

    if resilient_client_used():
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(rc)


def main(argv: Optional[List[str]] = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    try:
        rc = LearnTask().run(argv)
    except SystemExit:
        raise
    except BaseException:
        from .parallel.distributed import resilient_client_used

        if resilient_client_used():
            import traceback

            traceback.print_exc()
            _hard_exit_if_resilient(1)
        raise
    _hard_exit_if_resilient(rc)
    return rc
