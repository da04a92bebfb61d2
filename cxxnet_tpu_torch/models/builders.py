"""Conf-text builders for the models the port runs.

Counterpart of ``cxxnet_tpu/models/builders.py`` for the byte-level
transformer language model: ``_tail``, ``_transformer_blocks`` and
``transformer_lm_conf`` are copied so that they emit the same conf text
(the tests hold them equal).  ``dev = tpu`` in that text means the card
to the port (``nnet.trainer.resolve_device``).
"""

from __future__ import annotations


def _tail(
    batch_size: int,
    input_shape: str,
    num_round: int,
    eta: float = 0.01,
    extra: str = "",
    dev: str = "tpu",
    scan_steps: int = 8,
) -> str:
    # scan_steps: the CLI runs k batches as ONE device program
    # (doc/tasks.md); the trainer ignores the key in programmatic use
    return (
        f"input_shape = {input_shape}\n"
        f"batch_size = {batch_size}\n"
        f"dev = {dev}\n"
        f"num_round = {num_round}\n"
        f"max_round = {num_round}\n"
        "updater = sgd\n"
        f"eta = {eta}\n"
        "momentum = 0.9\n"
        "wd = 0.0005\n"
        f"scan_steps = {scan_steps}\n"
        "metric = error\n"
        "eval_train = 1\n"
        "print_step = 100\n"
        f"{extra}"
    )


def _transformer_blocks(
    prev: str,
    nlayer: int,
    nhead: int,
    dim: int,
    causal: int,
    seq_parallel: int,
    attn_impl: str = "auto",
) -> tuple:
    """Shared pre-norm block emission for transformer_conf /
    transformer_lm_conf: layer_norm -> attention -> residual ->
    layer_norm -> 4x MLP -> residual, per block.  Returns
    ``(conf_text, last_node)``."""
    s = ""
    for i in range(nlayer):
        b = f"b{i}"
        s += (
            f"layer[{prev}->{b}_n1] = layer_norm:{b}_ln1\n"
            f"layer[{b}_n1->{b}_a] = attention:{b}_attn\n"
            f"  nhead = {nhead}\n"
            f"  causal = {causal}\n"
            f"  seq_parallel = {seq_parallel}\n"
            f"  attn_impl = {attn_impl}\n"
            "  init_sigma = 0.02\n"
            f"layer[{prev},{b}_a->{b}_r1] = eltwise_sum\n"
            f"layer[{b}_r1->{b}_n2] = layer_norm:{b}_ln2\n"
            f"layer[{b}_n2->{b}_h] = fullc:{b}_fc1\n"
            f"  nhidden = {dim * 4}\n  init_sigma = 0.02\n"
            f"layer[+1:{b}_g] = gelu\n"
            f"layer[{b}_g->{b}_o] = fullc:{b}_fc2\n"
            f"  nhidden = {dim}\n  init_sigma = 0.02\n"
            f"layer[{b}_r1,{b}_o->{b}_r2] = eltwise_sum\n"
        )
        prev = f"{b}_r2"
    return s, prev


def transformer_lm_conf(
    vocab: int = 256,
    seq_len: int = 128,
    dim: int = 128,
    nhead: int = 4,
    nlayer: int = 2,
    text_file: str = "",
    batch_size: int = 16,
    num_round: int = 10,
    seq_parallel: int = 0,
    dev: str = "tpu",
    compute_dtype: str = "bfloat16",
    attn_impl: str = "auto",
    eta: float = 0.003,
) -> str:
    """Byte-level causal transformer language model.

    New TPU-first scope (the reference has no sequence models): the full
    LM pipeline — ``text`` iterator (byte windows + next-byte labels),
    ``embedding`` with learned positions, pre-norm causal blocks (flash
    attention via ``attn_impl``, sequence parallelism via
    ``seq_parallel``), a per-position softmax over the vocabulary, and
    per-token error/logloss metrics.  ``task = generate`` samples from a
    trained checkpoint (cli.py).
    """
    data = ""
    if text_file:
        data = (
            "data = train\n"
            "iter = text\n"
            f"  filename = {text_file}\n"
            f"  seq_len = {seq_len}\n"
            "  shuffle = 1\n"
            "iter = end\n"
        )
    s = (
        "netconfig = start\n"
        "layer[0->emb] = embedding:embed\n"
        f"  nvocab = {vocab}\n"
        f"  nhidden = {dim}\n"
        "  pos = learned\n"
        "  init_sigma = 0.02\n"
    )
    blocks, prev = _transformer_blocks(
        "emb", nlayer, nhead, dim, 1, seq_parallel, attn_impl
    )
    s += blocks
    s += (
        f"layer[{prev}->nf] = layer_norm:ln_f\n"
        f"layer[nf->logits] = fullc:lm_head\n"
        f"  nhidden = {vocab}\n  init_sigma = 0.02\n"
        "layer[logits->logits] = softmax\n"
        # per-token mean: the loss sums over T positions, so scale by
        # 1/T to keep eta in the familiar per-instance range
        f"  grad_scale = {1.0 / seq_len!r}\n"
        "netconfig = end\n"
    )
    extra = (
        f"compute_dtype = {compute_dtype}\n"
        f"label_width = {seq_len}\n"
        f"label_vec[0,{seq_len}) = label\n"
        "metric = logloss\n"
        # transformers want Adam; override _tail's sgd+momentum
        "updater = adam\n"
        "wd = 0.0\n"
    )
    return data + s + _tail(
        batch_size, f"1,1,{seq_len}", num_round, eta=eta, dev=dev,
        extra=extra,
    )
