"""Post-training quantized export: plan, accuracy gate, artifact.

Counterpart of ``cxxnet_tpu/nnet/quant.py``.  A trained f32 checkpoint
becomes an int8-weight serving artifact in one gated step:

1. **plan**: every plain conv / fullc kernel is assigned ``int8``
   (per-output-channel symmetric scales, ``ops/quant.py``);
   ``scheme = bf16`` assigns ``bf16`` everywhere;
2. **gate**: the quantized model must agree with the f32 model on
   held-out data, top-1 agreement >= ``quant_min_agreement`` (default
   0.99) over ``quant_calib_batches`` eval batches (0: the whole eval
   set).  While it fails, the int8 layer with the worst relative
   quantization error falls back to bf16 and the agreement is measured
   again;
3. **artifact**: on pass, the model is written as ``<round>.quant.model``
   beside its source, atomically and with a manifest whose ``quant``
   field records the scheme, the scales' dtype, the layer counts and the
   agreement.  On reject nothing is written.

The artifact is the JAX package's: int8 codes and f32 scales, bf16
kernels as ``~bf16`` uint16 words, in the normal checkpoint container,
so an artifact exported by either package serves in both.  ``quant =
int8`` on a plain checkpoint quantizes on load instead, ungated.

A publish emits ``quant.export`` and a reject ``quant.reject``
(``obs/events.py``), and both count in
``quant_export_total{decision}`` (``published`` / ``rejected``), as in
the JAX package.  ``conv_wino`` / ``conv_s2d`` convs start the plan at
bf16 (``build_plan``), as the JAX plan does.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..layers.conv import ConvolutionLayer
from ..layers.linear import FullConnectLayer
from ..obs import events as obs_events
from ..obs.registry import registry as obs_registry
from ..ops import quant as opsq
from ..utils import checkpoint as ckpt

__all__ = [
    "SCHEMES", "build_plan", "apply_plan", "top1_agreement",
    "export_quantized", "quant_artifact_path",
]

SCHEMES = ("int8", "bf16")


def quant_artifact_path(model_path: str) -> str:
    """``NNNN.model`` -> ``NNNN.quant.model``: the sibling the serving
    engine prefers under ``quant = int8``, invisible to the plain
    ``*.model`` round discovery."""
    if model_path.endswith(".quant.model"):
        return model_path
    if model_path.endswith(".model"):
        return model_path[:-len(".model")] + ".quant.model"
    return model_path + ".quant.model"


# ----------------------------------------------------------------------
# plan
def _layer_kinds(net) -> Dict[str, str]:
    """``param_key -> "conv" | "fullc"`` for the quantizable layers:
    exactly the types the quantized dispatch handles."""
    out: Dict[str, str] = {}
    for i, spec in enumerate(net.graph.layers):
        if spec.type_name == "shared":
            continue
        lay = net.layer_objs[i]
        if type(lay) is ConvolutionLayer:
            out[net.param_key[i]] = "conv"
        elif type(lay) is FullConnectLayer:
            out[net.param_key[i]] = "fullc"
    return out


def build_plan(trainer, scheme: str = "int8") -> Dict[str, str]:
    """``param_key -> "int8" | "bf16"`` for every quantizable layer of
    ``trainer``'s net: all ``scheme``, but a conv that opted into a
    rewrite (``conv_wino`` / ``conv_s2d``) stays bf16 under ``int8``: the
    quantized apply is the direct conv, which would override the
    rewrite."""
    if scheme not in SCHEMES:
        raise ValueError(f"quant scheme must be one of {SCHEMES}, "
                         f"got {scheme!r}")
    net = trainer.net
    kinds = _layer_kinds(net)
    plan = {}
    for key, lay in zip(net.param_key, net.layer_objs):
        if key not in kinds or key not in (trainer.params or {}):
            continue
        rewritten = kinds[key] == "conv" and (lay.conv_wino or lay.conv_s2d)
        plan[key] = "bf16" if rewritten else scheme
    return plan


def _out_axis(kind: str) -> int:
    return 3 if kind == "conv" else 0  # HWIO vs (nout, nin)


def apply_plan(trainer, plan: Dict[str, str], scheme: str = "int8",
               source_params=None) -> None:
    """Replace ``trainer``'s kernels per ``plan`` (int8 codes and scales,
    or a bf16 cast).  ``source_params`` (default: the trainer's own)
    supplies the f32 masters, so a revised plan is always quantized from
    the original weights.  Marks the trainer inference-only."""
    kinds = _layer_kinds(trainer.net)
    src = source_params if source_params is not None else trainer.params
    newp = {}
    for key, tags in src.items():
        kind = plan.get(key)
        if kind is None or key not in kinds:
            newp[key] = dict(tags)
            continue
        entry = {t: v for t, v in tags.items() if t != "wmat"}
        w = tags["wmat"].detach().float().cpu().numpy()
        if kind == "int8":
            q, s = opsq.quantize_weight(w, _out_axis(kinds[key]))
            entry[opsq.QKEY] = torch.from_numpy(q)
            entry[opsq.SKEY] = torch.from_numpy(s)
        else:  # bf16 fallback
            entry["wmat"] = torch.from_numpy(w).to(torch.bfloat16)
        newp[key] = entry
    trainer._set_master(newp, scheme, dict(plan))


# ----------------------------------------------------------------------
# gate
def top1_agreement(tr_ref, tr_cand, eval_iter,
                   max_batches: int = 0) -> Tuple[float, int]:
    """``(agreement, rows)``: the share of held-out rows on which the
    candidate's prediction (the trainer's ``predict``) equals the
    reference's, over up to ``max_batches`` eval batches (0: all)."""
    agree = 0
    total = 0
    batches = 0
    eval_iter.before_first()
    while eval_iter.next():
        batch = eval_iter.value()
        n = batch.batch_size - batch.num_batch_padd
        pr = np.asarray(tr_ref.predict(batch.data,
                                       batch.extra_data))[:n]
        pc = np.asarray(tr_cand.predict(batch.data,
                                       batch.extra_data))[:n]
        eq = pr.reshape(n, -1) == pc.reshape(n, -1)
        agree += int(eq.all(axis=1).sum())
        total += n
        batches += 1
        if max_batches and batches >= max_batches:
            break
    if total == 0:
        raise ValueError(
            "top1_agreement: the eval iterator yielded no rows; the "
            "agreement gate needs held-out data")
    return agree / total, total


def _error_ranking(trainer, plan: Dict[str, str]) -> List[Tuple[float, str]]:
    """The int8 layers by relative quantization error, worst first: the
    fallback order when the gate fails."""
    kinds = _layer_kinds(trainer.net)
    rank = []
    for key, kind in plan.items():
        if kind != "int8":
            continue
        w = trainer.params[key]["wmat"].detach().float().cpu().numpy()
        rank.append((opsq.quant_error(w, _out_axis(kinds[key])), key))
    return sorted(rank, reverse=True)


# ----------------------------------------------------------------------
# export
def export_quantized(
    cfg,
    model_path: str,
    eval_iter=None,
    scheme: str = "int8",
    min_agreement: float = 0.99,
    calib_batches: int = 0,
    out_path: Optional[str] = None,
    silent: bool = True,
) -> dict:
    """The gated export (``task=export_quant``).  Returns the verdict;
    writes the artifact only when the gate passes.  ``min_agreement =
    0`` skips the gate (``eval_iter`` may then be None)."""
    from .trainer import NetTrainer

    cfg = [(n, v) for n, v in cfg if n != "quant"]
    reason = ckpt.validate_checkpoint(model_path)
    if reason is not None:
        raise ckpt.CheckpointError(f"{model_path}: {reason}")

    def _load() -> NetTrainer:
        tr = NetTrainer()
        tr.set_params(cfg)
        tr.load_model(model_path)
        return tr

    ref = _load()
    if ref.quant_scheme:
        raise ValueError(
            f"{model_path} is already a quantized artifact "
            f"({ref.quant_scheme}); export from the f32 checkpoint")
    cand = _load()
    plan = build_plan(ref, scheme)
    if not plan:
        raise ValueError(
            "no quantizable layers (conv/fullc) in this net: nothing to "
            "export")
    gate = min_agreement > 0
    if gate and eval_iter is None:
        raise ValueError(
            "export_quantized: the agreement gate needs an eval iterator "
            "(set quant_min_agreement=0 to export ungated)")
    ranking = _error_ranking(ref, plan)
    agreement, rows = 1.0, 0
    fallbacks: List[str] = []
    while True:
        apply_plan(cand, plan, scheme, source_params=ref.params)
        if not gate:
            break
        agreement, rows = top1_agreement(ref, cand, eval_iter,
                                         max_batches=calib_batches)
        if agreement >= min_agreement:
            break
        demote = next((key for _e, key in ranking
                       if plan.get(key) == "int8"), None)
        if demote is None:
            break  # every layer already bf16: the gate loses
        plan[demote] = "bf16"
        fallbacks.append(demote)
        if not silent:
            print(f"quant: agreement {agreement:.4f} < "
                  f"{min_agreement:g}; falling back {demote} to bf16",
                  flush=True)
    ok = (not gate) or agreement >= min_agreement
    actual, f32_equiv = opsq.weight_bytes(cand.params)
    n_int8 = sum(1 for v in plan.values() if v == "int8")
    n_bf16 = sum(1 for v in plan.values() if v == "bf16")
    verdict = {
        "ok": bool(ok),
        "scheme": scheme,
        "source": model_path,
        "agreement": (agreement if gate else None),
        "min_agreement": min_agreement,
        "gated": gate,
        "eval_rows": rows,
        "calib_batches": calib_batches,
        "layers": dict(plan),
        "int8_layers": n_int8,
        "bf16_layers": n_bf16,
        "fallbacks": fallbacks,
        "weight_bytes": actual,
        "weight_bytes_f32": f32_equiv,
        "bytes_ratio": (f32_equiv / actual) if actual else 0.0,
        "path": None,
    }
    if not ok:
        # reject: nothing reaches disk, the f32 artifact keeps serving
        obs_events.emit("quant.reject", source=model_path, scheme=scheme,
                        agreement=agreement, min_agreement=min_agreement,
                        fallbacks=len(fallbacks))
        _count("rejected")
        if not silent:
            print(f"quant: REJECTED, agreement {agreement:.4f} < "
                  f"{min_agreement:g} even with every layer at bf16",
                  flush=True)
        return verdict
    path = out_path or quant_artifact_path(model_path)
    man = ckpt.read_manifest(model_path) or {}
    round_ = man.get("round")
    if round_ is None:
        round_ = ckpt.checkpoint_round(model_path)
    cand.round = round_ if round_ is not None else 0
    ckpt.write_checkpoint(
        path, cand.checkpoint_bytes(), round_=round_, net_fp=cand.net_fp(),
        quant={
            "scheme": scheme,
            "scales_dtype": "float32",
            "int8_layers": n_int8,
            "bf16_layers": n_bf16,
            "agreement": (agreement if gate else None),
            "source_crc32": man.get("crc32"),
        },
    )
    verdict["path"] = path
    obs_events.emit("quant.export", source=model_path, path=path,
                    scheme=scheme, agreement=(agreement if gate else None),
                    int8_layers=n_int8, bf16_layers=n_bf16,
                    bytes_ratio=verdict["bytes_ratio"])
    _count("published")
    if not silent:
        ag = f"{agreement:.4f}" if gate else "ungated"
        print(f"quant: exported {path} (scheme {scheme}, agreement {ag}, "
              f"{n_int8} int8 + {n_bf16} bf16 layers, "
              f"{verdict['bytes_ratio']:.2f}x smaller weights)", flush=True)
    return verdict


def _count(decision: str) -> None:
    obs_registry().counter(
        "quant_export_total",
        "Gated quantized exports by decision: published / rejected.",
        labelnames=("decision",),
    ).labels(decision=decision).inc()
